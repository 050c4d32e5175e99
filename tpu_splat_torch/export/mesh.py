"""Mesh export from a trained gaussian splat: density grid -> marching
tetrahedra -> vertex-colored .ply/.obj/.glb (the port of
tpu_splat/export/mesh.py).

The delivery-format analog of the reference's nerfacto mesh path
(main.py:1388-1468: ns-export poisson -> texture -> obj_to_glb at :230-246):
the trained splats define an opacity-weighted density field, polygonized by
marching tetrahedra with cases derived from first principles at import.

The grid and the polygonization run on the device in f64. The deposit sums
each cell's contributions in a fixed order (sorted by cell, splat order within
a cell) instead of `index_put_(accumulate=True)`, which is atomic on CUDA, so
two identical calls agree bit for bit. Triangles come out in the reference's
order: tetrahedra, then cases 1-14, then the case's triangles. The writers are
the reference's.
"""

from __future__ import annotations

import json
import struct
from typing import Tuple

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.core.types import GaussianCloud, to_numpy
from tpu_splat_torch.export.measurement import quantile

SH_C0 = 0.282095
F64 = torch.float64
DEPOSIT_CHUNK = 1 << 24  # (splat, cell) contributions summed at once

# 6-tetrahedra cube decomposition, all sharing the 0-6 diagonal (consistent
# orientation). Corner order: bit0=x, bit1=y, bit2=z.
_TETS = np.array([
    (0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
    (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6),
], np.int32)
# Corners ordered as the classic MC cube walk: the xy ring, then the +z ring.
_CORNER_OFF = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int32)


def _tet_case_table():
    """For each 4-bit inside-mask: list of triangles, each a triple of edges,
    each edge a (corner_a, corner_b) pair within the tetrahedron."""
    cases = []
    for mask in range(16):
        inside = [i for i in range(4) if mask >> i & 1]
        outside = [i for i in range(4) if not mask >> i & 1]
        tris = []
        if len(inside) in (1, 3):
            solo, others = (
                (inside[0], outside) if len(inside) == 1 else (outside[0], inside)
            )
            e = [(solo, o) for o in others]
            tris = [(e[0], e[1], e[2])]
        elif len(inside) == 2:
            a1, a2 = inside
            b1, b2 = outside
            e = [(a1, b1), (a1, b2), (a2, b2), (a2, b1)]
            tris = [(e[0], e[1], e[2]), (e[0], e[2], e[3])]
        cases.append(tris)
    return cases


_CASES = _tet_case_table()


def _deposit(density, color, res: int, base, frac, w_op, col, rr: int):
    """Add the splats of footprint radius rr, over their (2 rr + 2)^3 cells,
    to the flat (res^3) grids, in chunks of splats: each chunk's
    contributions are sorted by cell (stable, so splat order within a cell)
    and summed per cell with segment_reduce, then added to the grid at
    distinct cells."""
    dev = density.device
    offs = torch.arange(-rr, rr + 2, device=dev)
    o = torch.stack(torch.meshgrid(offs, offs, offs, indexing="ij"), -1).reshape(-1, 3)
    sig2 = max(rr, 0.6) ** 2
    per = max(1, DEPOSIT_CHUNK // len(o))
    for s in range(0, len(base), per):
        b, f = base[s:s + per], frac[s:s + per]
        d2 = ((o[None, :, 0] - f[:, None, 0]) ** 2 + (o[None, :, 1] - f[:, None, 1]) ** 2
              + (o[None, :, 2] - f[:, None, 2]) ** 2)
        w = w_op[s:s + per, None] * torch.exp(-0.5 * d2 / sig2)  # (G, F)
        cell = torch.clamp(b[:, None, :] + o[None], 0, res - 1)
        key = ((cell[..., 0] * res + cell[..., 1]) * res + cell[..., 2]).reshape(-1)
        order = torch.argsort(key, stable=True)
        key = key[order]
        uniq, lengths = torch.unique_consecutive(key, return_counts=True)
        wsum = torch.segment_reduce(w.reshape(-1)[order], "sum", lengths=lengths)
        csum = torch.segment_reduce(
            (w[..., None] * col[s:s + per, None, :]).reshape(-1, 3)[order], "sum",
            lengths=lengths, axis=0)
        density[uniq] += wsum
        color[uniq] += csum


def _density_grid(cloud: GaussianCloud, resolution: int, pad: float, dev):
    """Tensors on `dev`: (density (R,R,R), rgb (R,R,R,3), origin (3,), cell)."""
    t = lambda a: torch.as_tensor(to_numpy(a), device=dev).to(F64)  # noqa: E731
    means = t(cloud.means)
    opac = 1.0 / (1.0 + torch.exp(-t(cloud.opacities)))
    scales = torch.exp(t(cloud.scales)).mean(dim=1)
    rgb = torch.clamp(0.5 + SH_C0 * t(cloud.sh0), 0, 1)

    # robust bounds: ignore far-out floaters
    lo = quantile(means, 0.01)
    hi = quantile(means, 0.99)
    span = float(torch.max(hi - lo))
    lo = lo - pad * span
    hi = hi + pad * span
    cell = float(torch.max(hi - lo)) / (resolution - 1)
    origin = lo

    density = torch.zeros(resolution ** 3, dtype=F64, device=dev)
    color = torch.zeros((resolution ** 3, 3), dtype=F64, device=dev)

    # deposit over a (2r+2)^3 neighborhood; r from splat scale in cells
    g = (means - origin) / cell
    r_cells = torch.clamp(torch.round(scales / cell).to(torch.int64), 0, 2)
    base = torch.floor(g).to(torch.int64)
    frac = g - base
    for rr in range(3):  # group splats by footprint radius, as the reference
        sel = torch.nonzero(r_cells == rr)[:, 0]
        if len(sel):
            _deposit(density, color, resolution, base[sel], frac[sel], opac[sel], rgb[sel],
                     rr)
    color = color / torch.clamp_min(density[:, None], 1e-9)
    shape = (resolution,) * 3
    return density.reshape(shape), color.reshape(shape + (3,)), origin, cell


def splat_density_grid(
    cloud: GaussianCloud, resolution: int = 128, pad: float = 0.05, device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Opacity-weighted density + color grids from the splat cloud, built on
    `device` (CUDA unless the CPU is asked for).

    Each splat deposits its opacity over a trilinear footprint scaled by its
    mean extent (isotropic approximation of the anisotropic gaussian — the
    grid is for meshing, not rendering). Returns (density (R,R,R),
    rgb (R,R,R,3), origin (3,), cell_size)."""
    density, color, origin, cell = _density_grid(cloud, resolution, pad,
                                                 resolve_device(device))
    return density.cpu().numpy(), color.cpu().numpy(), origin.cpu().numpy(), cell


def _polygonize(density: torch.Tensor, iso: float) -> Tuple[torch.Tensor, torch.Tensor]:
    r = density.shape[0]
    n = r - 1
    dev = density.device
    # corner values for every cube: (C, 8), through flat indices
    ar = torch.arange(n, device=dev)
    cube_base = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1).reshape(-1, 3)
    off = torch.as_tensor(_CORNER_OFF, dtype=torch.int64, device=dev)
    flat_off = (off[:, 0] * r + off[:, 1]) * r + off[:, 2]
    flat_base = (cube_base[:, 0] * r + cube_base[:, 1]) * r + cube_base[:, 2]
    vals = density.reshape(-1)[flat_base[:, None] + flat_off[None, :]]

    # keep only cubes the surface crosses
    crosses = (vals.max(dim=1).values > iso) & (vals.min(dim=1).values <= iso)
    keep = torch.nonzero(crosses)[:, 0]
    if len(keep) == 0:
        return (torch.zeros((0, 3), dtype=F64, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev))
    corner_pos = (cube_base[keep][:, None, :] + off[None]).to(F64)  # (C, 8, 3)
    vals = vals[keep]

    tri_pts = []
    bits = torch.tensor([1, 2, 4, 8], device=dev)
    for tet in _TETS:
        tet_i = torch.as_tensor(tet, dtype=torch.int64, device=dev)
        tv = vals[:, tet_i]  # (C, 4)
        tp = corner_pos[:, tet_i, :]  # (C, 4, 3)
        mask = ((tv > iso).to(torch.int64) * bits).sum(dim=1)
        for case in range(1, 15):
            sel = torch.nonzero(mask == case)[:, 0]
            if len(sel) == 0:
                continue
            v = tv[sel]
            p = tp[sel]
            for tri in _CASES[case]:
                pts = []
                for (a, b) in tri:
                    dv = v[:, b] - v[:, a]
                    t = (iso - v[:, a]) / torch.where(dv.abs() < 1e-12,
                                                      torch.full_like(dv, 1e-12), dv)
                    t = torch.clamp(t, 0.0, 1.0)[:, None]
                    pts.append(p[:, a] * (1 - t) + p[:, b] * t)
                tri_pts.append(torch.stack(pts, dim=1))  # (M, 3, 3)
    tris = torch.cat(tri_pts, dim=0)  # (F, 3, 3)

    # orient: normal should point from inside (high density) to outside —
    # compare against the density gradient at the triangle centroid
    # (written as numpy's roundings: the centroid as ((p0 + p1) + p2) / 3,
    # the dot products left to right)
    cen = ((tris[:, 0] + tris[:, 1]) + tris[:, 2]) / 3
    ci = torch.clamp(torch.round(cen).to(torch.int64), 1, r - 2)
    x, y, z = ci[:, 0], ci[:, 1], ci[:, 2]
    grad = torch.stack([
        density[x + 1, y, z] - density[x - 1, y, z],
        density[x, y + 1, z] - density[x, y - 1, z],
        density[x, y, z + 1] - density[x, y, z - 1],
    ], dim=1)
    e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    nrm = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                       e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                       e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    prod = nrm * grad
    flip = (prod[:, 0] + prod[:, 1]) + prod[:, 2] > 0  # normal along +gradient = inward
    tris = torch.where(flip[:, None, None], tris.flip(1), tris)

    # dedup vertices (quantized — interpolated points are shared across tets),
    # keeping each key's first position in the reference's sorted key order
    flat = tris.reshape(-1, 3)
    quant = torch.round(flat * 4096.0).to(torch.int64)
    _, inv = torch.unique(quant, dim=0, sorted=True, return_inverse=True)
    n_uniq = int(inv.max()) + 1
    first = torch.full((n_uniq,), len(flat), dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, inv, torch.arange(len(flat), device=dev), "amin")
    verts = flat[first]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts, faces[good]


def marching_tetrahedra(
    density: np.ndarray, iso: float, device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Polygonize the iso-surface on `device` (CUDA unless the CPU is asked
    for). Returns (verts (V,3) in grid coords, faces (F,3) int32), vertices
    deduplicated, triangles oriented with normals pointing toward decreasing
    density (outward)."""
    d = torch.as_tensor(np.asarray(density, np.float64), device=resolve_device(device))
    verts, faces = _polygonize(d, iso)
    return verts.cpu().numpy().astype(np.float32), faces.cpu().numpy().astype(np.int32)


def extract_mesh(
    cloud: GaussianCloud,
    resolution: int = 128,
    iso_quantile: float = 0.6,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Splat -> (verts (V,3) world coords, faces (F,3), colors (V,3) [0,1]),
    on `device` (CUDA unless the CPU is asked for)."""
    dev = resolve_device(device)
    density, color, origin, cell = _density_grid(cloud, resolution, 0.05, dev)
    occupied = density[density > 1e-4]
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
             np.zeros((0, 3), np.float32))
    if occupied.numel() == 0:
        return empty
    iso = float(quantile(occupied, iso_quantile))
    verts_g, faces = _polygonize(density, iso)
    if len(verts_g) == 0:
        return empty
    verts_g = verts_g.to(torch.float32)
    vi = torch.clamp(torch.round(verts_g).to(torch.int64), 0, resolution - 1)
    colors = color[vi[:, 0], vi[:, 1], vi[:, 2]].to(torch.float32)
    verts = (verts_g * cell + origin).to(torch.float32)
    return (verts.cpu().numpy(), faces.cpu().numpy().astype(np.int32),
            colors.cpu().numpy())


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------


def save_mesh_ply(path: str, verts, faces, colors):
    """ASCII ply with vertex colors (the poisson_mesh.ply analog)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        c8 = np.clip(colors * 255, 0, 255).astype(np.uint8)
        for v, c in zip(verts, c8):
            f.write(f"{v[0]:.5f} {v[1]:.5f} {v[2]:.5f} {c[0]} {c[1]} {c[2]}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def save_mesh_obj(path: str, verts, faces, colors):
    """Wavefront obj with per-vertex colors (the common xyzrgb extension)."""
    with open(path, "w") as f:
        for v, c in zip(verts, colors):
            f.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f} "
                    f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        for tri in faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def save_mesh_glb(path: str, verts, faces, colors, y_up: bool = True):
    """Binary glTF 2.0 with POSITION + COLOR_0 + indices (obj_to_glb analog,
    main.py:230-246 — including its -90 deg x rotation to the glTF y-up
    convention)."""
    verts = np.asarray(verts, np.float32)
    if y_up and len(verts):  # -90 deg about x: (x, y, z) -> (x, z, -y)
        verts = np.ascontiguousarray(
            np.stack([verts[:, 0], verts[:, 2], -verts[:, 1]], 1), np.float32
        )
    colors = np.asarray(colors, np.float32)
    idx = np.asarray(faces, np.uint32).reshape(-1)

    def pad4(b: bytes, fill=b"\x00") -> bytes:
        return b + fill * ((4 - len(b) % 4) % 4)

    bin_pos = verts.tobytes()
    bin_col = colors.tobytes()
    bin_idx = idx.tobytes()
    off_pos, off_col, off_idx = 0, len(bin_pos), len(bin_pos) + len(bin_col)
    binary = pad4(bin_pos + bin_col + bin_idx)

    mins = verts.min(axis=0).tolist() if len(verts) else [0, 0, 0]
    maxs = verts.max(axis=0).tolist() if len(verts) else [0, 0, 0]
    gltf = {
        "asset": {"version": "2.0", "generator": "tpu-splat"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{
            "primitives": [{
                "attributes": {"POSITION": 0, "COLOR_0": 1},
                "indices": 2,
                "mode": 4,
            }]
        }],
        "buffers": [{"byteLength": len(binary)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": off_pos, "byteLength": len(bin_pos),
             "target": 34962},
            {"buffer": 0, "byteOffset": off_col, "byteLength": len(bin_col),
             "target": 34962},
            {"buffer": 0, "byteOffset": off_idx, "byteLength": len(bin_idx),
             "target": 34963},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(verts),
             "type": "VEC3", "min": mins, "max": maxs},
            {"bufferView": 1, "componentType": 5126, "count": len(colors),
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"},
        ],
    }
    js = pad4(json.dumps(gltf, separators=(",", ":")).encode(), b" ")
    total = 12 + 8 + len(js) + 8 + len(binary)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))  # glTF magic
        f.write(struct.pack("<II", len(js), 0x4E4F534A))  # JSON chunk
        f.write(js)
        f.write(struct.pack("<II", len(binary), 0x004E4942))  # BIN chunk
        f.write(binary)


def export_mesh_artifacts(cloud: GaussianCloud, out_dir: str,
                          resolution: int = 128, device=None) -> dict:
    """Produce the reference's mesh deliverable set: poisson_mesh.ply,
    textured/mesh.obj, textured/mesh.glb; the mesh is extracted on `device`
    (CUDA unless the CPU is asked for)."""
    import os

    verts, faces, colors = extract_mesh(cloud, resolution=resolution, device=device)
    tex_dir = os.path.join(out_dir, "textured")
    os.makedirs(tex_dir, exist_ok=True)
    ply = os.path.join(out_dir, "poisson_mesh.ply")
    obj = os.path.join(tex_dir, "mesh.obj")
    glb = os.path.join(tex_dir, "mesh.glb")
    save_mesh_ply(ply, verts, faces, colors)
    save_mesh_obj(obj, verts, faces, colors)
    save_mesh_glb(glb, verts, faces, colors)
    return {"mesh_ply": ply, "mesh_obj": obj, "mesh_glb": glb,
            "n_vertices": len(verts), "n_faces": len(faces)}

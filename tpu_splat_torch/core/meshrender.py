"""CPU textured-mesh renderer — an EXTERNAL ground-truth source (the port of
tpu_splat/core/meshrender.py).

Every quality number in this repo would otherwise be self-referential: GT
captures rendered by the repo's own gaussian rasterizer cannot expose a
systematic renderer error. This module renders a
textured triangle mesh with a plain z-buffered, perspective-correct
barycentric rasterizer in numpy — sharing zero code or math with
gs/rasterize.py — so captures rendered from it are an independent oracle for
SfM accuracy and splat PSNR. It stays host numpy, as in the reference; only
render_erp's stitch of the six cube faces runs on a device, through the
port's spherical/projections.cubemap_to_erp.

Camera convention matches the repo (OpenCV: +x right, +y down, +z forward,
w2c matrices). Pure numpy + cv2; deliberately simple and slow-ish (~0.5 s per
720p frame at ~1K triangles).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class Mesh(NamedTuple):
    verts: np.ndarray      # (V, 3) float32 world-space vertices
    tris: np.ndarray       # (F, 3) int32 vertex indices
    uvs: np.ndarray        # (F, 3, 2) float32 per-corner texture coords [0,1]
    tex_ids: np.ndarray    # (F,) int32 index into textures
    textures: np.ndarray   # (T, R, R, 3) float32 texture images [0,1]


def render_mesh(mesh: Mesh, w2c: np.ndarray, fx: float, fy: float,
                cx: float, cy: float, width: int, height: int,
                background: Tuple[float, float, float] = (0.7, 0.7, 0.7),
                light_dir: Tuple[float, float, float] = (0.4, -0.8, 0.45),
                ) -> np.ndarray:
    """Render one view. Returns (H, W, 3) float32 in [0,1]."""
    v_cam = mesh.verts @ w2c[:3, :3].T + w2c[:3, 3]
    z = v_cam[:, 2]
    eps = 1e-6
    u = fx * v_cam[:, 0] / np.maximum(z, eps) + cx
    v = fy * v_cam[:, 1] / np.maximum(z, eps) + cy

    img = np.full((height, width, 3), background, np.float32)
    zbuf = np.full((height, width), np.inf, np.float32)
    light = np.asarray(light_dir, np.float32)
    light = light / np.linalg.norm(light)

    tri_z = z[mesh.tris].min(axis=1)
    order = np.argsort(tri_z)  # near-first: z-buffer skips most far work
    for f in order:
        i0, i1, i2 = mesh.tris[f]
        if z[i0] < 0.05 or z[i1] < 0.05 or z[i2] < 0.05:
            continue  # clip whole triangles crossing the near plane
        xs = np.array([u[i0], u[i1], u[i2]])
        ys = np.array([v[i0], v[i1], v[i2]])
        x_min = max(int(np.floor(xs.min())), 0)
        x_max = min(int(np.ceil(xs.max())) + 1, width)
        y_min = max(int(np.floor(ys.min())), 0)
        y_max = min(int(np.ceil(ys.max())) + 1, height)
        if x_min >= x_max or y_min >= y_max:
            continue
        # screen-space barycentrics over the bbox
        px, py = np.meshgrid(
            np.arange(x_min, x_max, dtype=np.float32) + 0.5,
            np.arange(y_min, y_max, dtype=np.float32) + 0.5)
        d = ((ys[1] - ys[2]) * (xs[0] - xs[2])
             + (xs[2] - xs[1]) * (ys[0] - ys[2]))
        if abs(d) < 1e-9:
            continue
        b0 = ((ys[1] - ys[2]) * (px - xs[2]) + (xs[2] - xs[1]) * (py - ys[2])) / d
        b1 = ((ys[2] - ys[0]) * (px - xs[2]) + (xs[0] - xs[2]) * (py - ys[2])) / d
        b2 = 1.0 - b0 - b1
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        if not inside.any():
            continue
        # perspective-correct interpolation: blend (attr/z) then divide
        iz = (b0 / z[i0] + b1 / z[i1] + b2 / z[i2])
        z_px = 1.0 / np.maximum(iz, 1e-9)
        zslab = zbuf[y_min:y_max, x_min:x_max]
        win = inside & (z_px < zslab)
        if not win.any():
            continue
        uv0, uv1, uv2 = mesh.uvs[f]
        tu = (b0 * uv0[0] / z[i0] + b1 * uv1[0] / z[i1]
              + b2 * uv2[0] / z[i2]) * z_px
        tv = (b0 * uv0[1] / z[i0] + b1 * uv1[1] / z[i1]
              + b2 * uv2[1] / z[i2]) * z_px
        tex = mesh.textures[mesh.tex_ids[f]]
        r = tex.shape[0]
        ti = np.clip((tv * (r - 1)), 0, r - 1)
        tj = np.clip((tu * (r - 1)), 0, r - 1)
        # bilinear texture sample
        i0f = np.floor(ti).astype(np.int32)
        j0f = np.floor(tj).astype(np.int32)
        i1f = np.minimum(i0f + 1, r - 1)
        j1f = np.minimum(j0f + 1, r - 1)
        wi = (ti - i0f)[..., None]
        wj = (tj - j0f)[..., None]
        col = ((tex[i0f, j0f] * (1 - wi) + tex[i1f, j0f] * wi) * (1 - wj)
               + (tex[i0f, j1f] * (1 - wi) + tex[i1f, j1f] * wi) * wj)
        # flat Lambert shading from the world-space face normal
        e1 = mesh.verts[i1] - mesh.verts[i0]
        e2 = mesh.verts[i2] - mesh.verts[i0]
        nrm = np.cross(e1, e2)
        nn = np.linalg.norm(nrm)
        if nn > 1e-12:
            nrm = nrm / nn
        shade = 0.45 + 0.55 * abs(float(np.dot(nrm, light)))
        islab = img[y_min:y_max, x_min:x_max]
        islab[win] = col[win] * shade
        zslab[win] = z_px[win]
    return img


def _face_texture(rng: np.random.Generator, r: int = 256) -> np.ndarray:
    """Feature-rich procedural texture. The detector needs HIGH-CONTRAST
    structure that survives 3-5x minification (a 256-texel face spans
    ~50-150 px in the benchmark captures), so the texture is dominated by
    large crisp shapes over contrast-stretched coarse noise — fine speckle
    alone blurs to gray at render scale and starves SIFT (measured: 127 vs
    285 keypoints per frame)."""
    import cv2

    t = np.zeros((r, r), np.float32)
    amp = 1.0
    for cells in (3, 6, 12, 24):
        g = rng.random((cells, cells)).astype(np.float32)
        t += amp * cv2.resize(g, (r, r), interpolation=cv2.INTER_CUBIC)
        amp *= 0.55
    t = (t - t.min()) / max(t.max() - t.min(), 1e-6)
    # contrast stretch: push the noise toward its extremes
    t = np.clip(1.5 * (t - 0.5) + 0.5, 0, 1)
    # large crisp shapes: the stable corner/blob features at minified scale
    for _ in range(14):
        val = float(rng.integers(0, 2))
        kind = rng.integers(0, 3)
        x, y = rng.integers(8, r - 8, 2)
        if kind == 0:
            cv2.circle(t, (int(x), int(y)), int(rng.integers(6, 22)), val, -1)
        elif kind == 1:
            w_, h_ = rng.integers(10, 44, 2)
            ang = float(rng.uniform(0, 180))
            box = cv2.boxPoints(((float(x), float(y)), (float(w_), float(h_)),
                                 ang))
            cv2.fillConvexPoly(t, box.astype(np.int32), val)
        else:
            x2, y2 = rng.integers(8, r - 8, 2)
            cv2.line(t, (int(x), int(y)), (int(x2), int(y2)), val,
                     int(rng.integers(3, 9)))
    c0 = rng.uniform(0.0, 1.0, 3).astype(np.float32)
    c1 = rng.uniform(0.0, 1.0, 3).astype(np.float32)
    while np.linalg.norm(c1 - c0) < 0.8:  # strong channel contrast
        c1 = rng.uniform(0.0, 1.0, 3).astype(np.float32)
    return t[..., None] * c1 + (1 - t[..., None]) * c0


def _box(center, size, rot=None, subdiv: int = 4):
    """Subdivided box: returns (verts, tris, uvs_per_corner, face_of_tri)."""
    cx, cy, cz = center
    sx, sy, sz = np.asarray(size) / 2.0
    verts = []
    tris = []
    uvs = []
    face_ids = []
    axes = [  # (normal axis, u axis, v axis, sign)
        (0, 1, 2, +1), (0, 1, 2, -1),
        (1, 0, 2, +1), (1, 0, 2, -1),
        (2, 0, 1, +1), (2, 0, 1, -1),
    ]
    half = np.array([sx, sy, sz])
    for face, (na, ua, va, sign) in enumerate(axes):
        base = len(verts)
        for i in range(subdiv + 1):
            for j in range(subdiv + 1):
                p = np.zeros(3)
                p[na] = sign * half[na]
                p[ua] = (2.0 * i / subdiv - 1.0) * half[ua]
                p[va] = (2.0 * j / subdiv - 1.0) * half[va]
                verts.append(p)
        for i in range(subdiv):
            for j in range(subdiv):
                a = base + i * (subdiv + 1) + j
                b = a + subdiv + 1
                u0, v0 = i / subdiv, j / subdiv
                u1, v1 = (i + 1) / subdiv, (j + 1) / subdiv
                tris.append((a, b, a + 1))
                uvs.append(((u0, v0), (u1, v0), (u0, v1)))
                face_ids.append(face)
                tris.append((a + 1, b, b + 1))
                uvs.append(((u0, v1), (u1, v0), (u1, v1)))
                face_ids.append(face)
    verts = np.asarray(verts, np.float32)
    if rot is not None:
        verts = verts @ np.asarray(rot, np.float32).T
    verts = verts + np.array([cx, cy, cz], np.float32)
    return (verts, np.asarray(tris, np.int32),
            np.asarray(uvs, np.float32), np.asarray(face_ids, np.int32))


def make_capture_scene(seed: int = 7) -> Mesh:
    """The standard benchmark scene: a textured box on a textured ground
    disc with three satellite boxes — closed geometry, features at several
    scales, parallax structure for SfM."""
    rng = np.random.default_rng(seed)
    all_v, all_t, all_uv, all_tid = [], [], [], []
    textures = []
    v_off = 0

    def rotz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    def roty(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def add(verts, tris, uvs, face_ids):
        nonlocal v_off
        all_v.append(verts)
        all_t.append(tris + v_off)
        all_uv.append(uvs)
        base_tex = len(textures)
        n_faces = int(face_ids.max()) + 1
        for _ in range(n_faces):
            textures.append(_face_texture(rng))
        all_tid.append(face_ids + base_tex)
        v_off += len(verts)

    # central box (the subject) — y is DOWN (OpenCV), ground at y=+0.9
    add(*_box((0.0, 0.15, 0.0), (1.6, 1.5, 1.1), rot=roty(0.4), subdiv=5))
    # satellites
    add(*_box((1.6, 0.55, -1.1), (0.7, 0.7, 0.7), rot=roty(1.1), subdiv=3))
    add(*_box((-1.4, 0.65, 1.0), (0.6, 0.5, 0.9), rot=roty(-0.7), subdiv=3))
    add(*_box((0.2, 0.72, 1.7), (0.5, 0.36, 0.5), rot=roty(2.2), subdiv=3))
    # ground slab (thin box, top face textured)
    add(*_box((0.0, 0.95, 0.0), (13.0, 0.1, 13.0), subdiv=8))
    # room walls: textured background everywhere the orbit looks (property-
    # scan regime; without them half of every frame is featureless sky and
    # the detector starves). Thin slabs at +-6.5, tall enough to fill the
    # horizon from any orbit viewpoint.
    add(*_box((6.5, -1.0, 0.0), (0.1, 4.0, 13.0), subdiv=6))
    add(*_box((-6.5, -1.0, 0.0), (0.1, 4.0, 13.0), subdiv=6))
    add(*_box((0.0, -1.0, 6.5), (13.0, 4.0, 0.1), subdiv=6))
    add(*_box((0.0, -1.0, -6.5), (13.0, 4.0, 0.1), subdiv=6))

    return Mesh(
        verts=np.concatenate(all_v).astype(np.float32),
        tris=np.concatenate(all_t).astype(np.int32),
        uvs=np.concatenate(all_uv).astype(np.float32),
        tex_ids=np.concatenate(all_tid).astype(np.int32),
        textures=np.stack(textures).astype(np.float32),
    )


def render_erp(mesh: Mesh, eye, h: int, w: int, face_size: int = 256,
               background: Tuple[float, float, float] = (0.7, 0.7, 0.7),
               device=None) -> np.ndarray:
    """Render a full equirectangular panorama from `eye` by rendering the six
    cube faces with this mesh renderer and stitching them with the spherical
    module's cubemap_to_erp on `device` (CUDA unless the CPU is asked for) —
    a GT source for the 360-degree pipeline that is independent of the
    gaussian rasterizer (the ERP stitch itself is the spherical module under
    test's inverse, exercised by its own unit tests)."""
    import torch

    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.spherical.projections import (
        FACE_NAMES, _FACE_ROTS, cubemap_to_erp)

    s = face_size
    # cubemap_to_erp samples face pixel u = x/z*(s-1)/2 + (s-1)/2 at integer
    # pixel-center positions; the renderer's pixel j is centered at j+0.5, so
    # fx=(s-1)/2 with cx=s/2 makes the two grids coincide.
    f = (s - 1) / 2.0
    eye = np.asarray(eye, np.float64)
    faces = []
    for name in FACE_NAMES:
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = np.asarray(_FACE_ROTS[name], np.float32).T
        w2c[:3, 3] = -w2c[:3, :3] @ eye
        faces.append(render_mesh(mesh, w2c, f, f, s / 2, s / 2, s, s,
                                 background=background))
    erp = cubemap_to_erp(torch.as_tensor(np.stack(faces), device=resolve_device(device)),
                         h, w)
    return erp.cpu().numpy()


def orbit_w2c(ang: float, radius: float = 4.0, height: float = -0.6,
              target=(0.0, 0.3, 0.0)) -> np.ndarray:
    """OpenCV-convention world-to-camera for an orbit viewpoint (y down)."""
    eye = np.array([radius * np.cos(ang), height, radius * np.sin(ang)])
    tgt = np.asarray(target, np.float64)
    z = tgt - eye
    z = z / np.linalg.norm(z)
    # scene is y-DOWN (ground at +y): the camera +y axis must also point
    # world-down, so build the basis around the world-down vector
    down = np.array([0.0, 1.0, 0.0])
    x = np.cross(down, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = np.stack([x, y, z])
    w2c[:3, 3] = -w2c[:3, :3] @ eye
    return w2c

"""INRIA-layout Gaussian-splat .ply reader/writer (the port's copy of
tpu_splat/core/ply.py; output bytes are identical).

binary_little_endian float32 properties in the order
  x y z nx ny nz f_dc_0..2 f_rest_0..(3K-1) opacity scale_0..2 rot_0..3
where f_rest is channel-major and rot_0 = w. Normals are written as zeros.
"""

from __future__ import annotations

import io
from typing import Union

import numpy as np

from tpu_splat_torch.core.types import GaussianCloud, sh_degree_for_dim

MAX_PLY_POINTS = 10 * 1024 * 1024


def save_ply(cloud: GaussianCloud, path_or_file: Union[str, io.IOBase]) -> None:
    """Write a GaussianCloud in the INRIA splat .ply layout."""
    g = cloud.to_numpy()
    n = g.means.shape[0]
    k = g.shN.shape[1]

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    names = ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
    names += [f"f_rest_{i}" for i in range(3 * k)]
    names += ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]
    header += [f"property float {nm}" for nm in names]
    header.append("end_header")

    cols = 17 + 3 * k
    data = np.zeros((n, cols), dtype="<f4")
    data[:, 0:3] = g.means
    data[:, 6:9] = g.sh0
    if k:
        # (N, K, 3) coeff-major -> (N, 3, K) channel-major flattened
        data[:, 9 : 9 + 3 * k] = np.transpose(g.shN, (0, 2, 1)).reshape(n, 3 * k)
    o = 9 + 3 * k
    data[:, o] = g.opacities
    data[:, o + 1 : o + 4] = g.scales
    data[:, o + 4 : o + 8] = g.quats

    payload = "\n".join(header).encode("ascii") + b"\n" + data.tobytes()
    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file, "wb") as f:
            f.write(payload)
    else:
        path_or_file.write(payload)


def load_ply(path_or_file: Union[str, io.IOBase]) -> GaussianCloud:
    """Read an INRIA splat .ply into a GaussianCloud (all-float32 properties only)."""
    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file, "rb") as f:
            raw = f.read()
    else:
        raw = path_or_file.read()

    end = raw.find(b"end_header\n")
    if end < 0:
        raise ValueError("not a valid .ply: missing end_header")
    header_lines = raw[:end].decode("ascii", errors="replace").splitlines()
    body = raw[end + len(b"end_header\n") :]

    if not header_lines or header_lines[0].strip() != "ply":
        raise ValueError("not a .ply file")
    fmt = next((ln for ln in header_lines if ln.startswith("format ")), "")
    if fmt.strip() != "format binary_little_endian 1.0":
        raise ValueError(f"unsupported .ply format: {fmt!r}")

    n = -1
    fields: dict[str, int] = {}
    idx = 0
    for ln in header_lines[1:]:
        ln = ln.strip()
        if ln.startswith("comment"):
            continue
        if ln.startswith("element vertex "):
            n = int(ln[len("element vertex ") :])
            continue
        if ln.startswith("element "):
            raise ValueError(f"unsupported element: {ln!r}")
        if ln.startswith("property "):
            if not ln.startswith("property float "):
                raise ValueError(f"unsupported property data type: {ln!r}")
            fields[ln[len("property float ") :]] = idx
            idx += 1
    if n < 0 or n > MAX_PLY_POINTS:
        raise ValueError(f"invalid vertex count: {n}")

    ncols = len(fields)
    values = np.frombuffer(body, dtype="<f4", count=n * ncols).reshape(n, ncols)

    def col(name: str) -> np.ndarray:
        if name not in fields:
            raise ValueError(f"missing field: {name}")
        return values[:, fields[name]]

    means = np.stack([col("x"), col("y"), col("z")], axis=1)
    scales = np.stack([col("scale_0"), col("scale_1"), col("scale_2")], axis=1)
    quats = np.stack([col("rot_0"), col("rot_1"), col("rot_2"), col("rot_3")], axis=1)
    opac = col("opacity").copy()
    sh0 = np.stack([col("f_dc_0"), col("f_dc_1"), col("f_dc_2")], axis=1)

    rest_cols = []
    for i in range(45):
        if f"f_rest_{i}" not in fields:
            break
        rest_cols.append(values[:, fields[f"f_rest_{i}"]])
    k = len(rest_cols) // 3
    # keep only a whole number of (coeff, channel) triples
    k = {0: 0, 1: 1, 2: 2, 3: 3}.get(sh_degree_for_dim(k), 0) and k
    if k:
        rest = np.stack(rest_cols[: 3 * k], axis=1).reshape(n, 3, k)
        shN = np.ascontiguousarray(np.transpose(rest, (0, 2, 1)))
    else:
        shN = np.zeros((n, 0, 3), dtype=np.float32)

    return GaussianCloud(
        means=means.astype(np.float32),
        scales=scales.astype(np.float32),
        quats=quats.astype(np.float32),
        opacities=opac.astype(np.float32),
        sh0=sh0.astype(np.float32),
        shN=shN.astype(np.float32),
    )

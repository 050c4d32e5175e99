"""SPZ codec (the port's copy of tpu_splat/core/spz.py; output bytes are identical).

Niantic SPZ v2: gzip( header || positions || alphas || colors || scales ||
rotations || sh ). Header (16 bytes, little-endian): u32 magic "NGSP",
u32 version 2, u32 numPoints, u8 shDegree, u8 fractionalBits (12),
u8 flags (bit0 = antialiased), u8 reserved. Positions are 24-bit fixed point
with 12 fractional bits; alphas sigmoid*255; colors dc*0.15*255+127.5;
scales (log+10)*16; rotations xyz of the w>=0 unit quaternion *127.5+127.5;
SH quantized to 5 bits (degree-1 band) and 4 bits (the rest).
"""

from __future__ import annotations

import gzip
import io
import struct as pystruct
from typing import Union

import numpy as np

from tpu_splat_torch.core.types import SH_DIM_FOR_DEGREE, GaussianCloud

MAGIC = 0x5053474E
VERSION = 2
FLAG_ANTIALIASED = 0x1
COLOR_SCALE = 0.15
FRACTIONAL_BITS = 12
MAX_SPZ_POINTS = 10_000_000


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """std::round semantics: round half away from zero (np.round is half-to-even)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip(_round_half_away(x), 0, 255).astype(np.uint8)


def _quantize_sh(x: np.ndarray, bucket: int) -> np.ndarray:
    q = _round_half_away(x * 128.0).astype(np.int64) + 128
    # C++ integer division truncates toward zero; negatives clamp to 0 either way
    q = q + bucket // 2
    q = (np.sign(q) * (np.abs(q) // bucket)) * bucket
    return np.clip(q, 0, 255).astype(np.uint8)


def _unquantize_sh(x: np.ndarray) -> np.ndarray:
    return (x.astype(np.float32) - 128.0) / 128.0


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _inv_sigmoid(x: np.ndarray) -> np.ndarray:
    return np.log(x / (1.0 - x))


def pack_gaussians(cloud: GaussianCloud) -> bytes:
    """Serialize (uncompressed) packed gaussian bytes: header + quantized arrays."""
    g = cloud.to_numpy()
    n = int(g.means.shape[0])
    if n > MAX_SPZ_POINTS:
        raise ValueError(f"too many points for SPZ: {n}")
    sh_degree = cloud.sh_degree
    sh_dim = SH_DIM_FOR_DEGREE[sh_degree]

    header = pystruct.pack(
        "<IIIBBBB", MAGIC, VERSION, n, sh_degree, FRACTIONAL_BITS,
        FLAG_ANTIALIASED if cloud.antialiased else 0, 0,
    )

    scale = float(1 << FRACTIONAL_BITS)
    fixed = _round_half_away(g.means.astype(np.float64).reshape(-1) * scale).astype(np.int64)
    fixed = fixed.astype(np.uint32) & 0xFFFFFF
    pos = np.empty((fixed.shape[0], 3), dtype=np.uint8)
    pos[:, 0] = fixed & 0xFF
    pos[:, 1] = (fixed >> 8) & 0xFF
    pos[:, 2] = (fixed >> 16) & 0xFF

    alphas = _to_uint8(_sigmoid(g.opacities.astype(np.float64)) * 255.0)
    colors = _to_uint8(g.sh0.astype(np.float64) * (COLOR_SCALE * 255.0) + 0.5 * 255.0)
    scales = _to_uint8((g.scales.astype(np.float64) + 10.0) * 16.0)

    q = g.quats.astype(np.float64)  # wxyz
    norm = np.linalg.norm(q, axis=1, keepdims=True)
    norm = np.where(norm == 0, 1.0, norm)
    q = q / norm
    sign = np.where(q[:, :1] < 0, -1.0, 1.0)  # force w >= 0
    rots = _to_uint8(q[:, 1:4] * sign * 127.5 + 127.5)

    if sh_dim > 0:
        sh = g.shN.astype(np.float64)
        if sh.shape[1] != sh_dim:
            raise ValueError(f"shN has {sh.shape[1]} coeffs, expected {sh_dim}")
        flat = sh.reshape(n, sh_dim * 3)
        packed_sh = np.empty_like(flat, dtype=np.uint8)
        packed_sh[:, :9] = _quantize_sh(flat[:, :9], 1 << (8 - 5))
        if flat.shape[1] > 9:
            packed_sh[:, 9:] = _quantize_sh(flat[:, 9:], 1 << (8 - 4))
        sh_bytes = packed_sh.tobytes()
    else:
        sh_bytes = b""

    return (header + pos.tobytes() + alphas.tobytes() + colors.tobytes()
            + scales.tobytes() + rots.tobytes() + sh_bytes)


def save_spz(cloud: GaussianCloud, path_or_file: Union[str, io.IOBase]) -> None:
    """Write a gzip-compressed .spz file (mtime 0 for deterministic bytes)."""
    raw = pack_gaussians(cloud)
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", compresslevel=6, mtime=0) as gz:
        gz.write(raw)
    data = buf.getvalue()
    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file, "wb") as f:
            f.write(data)
    else:
        path_or_file.write(data)


def unpack_gaussians(raw: bytes) -> GaussianCloud:
    """Decode packed (uncompressed) gaussian bytes into a GaussianCloud."""
    if len(raw) < 16:
        raise ValueError("SPZ: truncated header")
    magic, version, n, sh_degree, frac_bits, flags, _ = pystruct.unpack("<IIIBBBB", raw[:16])
    if magic != MAGIC:
        raise ValueError("SPZ: bad magic")
    if not (1 <= version <= 2):
        raise ValueError(f"SPZ: unsupported version {version}")
    if n > MAX_SPZ_POINTS:
        raise ValueError(f"SPZ: too many points: {n}")
    if sh_degree > 3:
        raise ValueError(f"SPZ: unsupported SH degree {sh_degree}")
    if version == 1:
        raise ValueError("SPZ: legacy float16 v1 files not supported")

    sh_dim = SH_DIM_FOR_DEGREE[sh_degree]
    off = 16
    sizes = [n * 9, n, n * 3, n * 3, n * 3, n * sh_dim * 3]
    if len(raw) < off + sum(sizes):
        raise ValueError("SPZ: truncated payload")
    chunks = []
    for s in sizes:
        chunks.append(np.frombuffer(raw, dtype=np.uint8, count=s, offset=off))
        off += s
    pos_b, alphas_b, colors_b, scales_b, rots_b, sh_b = chunks

    p = pos_b.reshape(-1, 3).astype(np.int64)
    fixed = p[:, 0] | (p[:, 1] << 8) | (p[:, 2] << 16)
    fixed = np.where(fixed & 0x800000, fixed - (1 << 24), fixed)
    means = (fixed.astype(np.float32) * np.float32(1.0 / (1 << frac_bits))).reshape(n, 3)

    scales = scales_b.astype(np.float32).reshape(n, 3) / 16.0 - 10.0
    xyz = rots_b.astype(np.float32).reshape(n, 3) / 127.5 - 1.0
    w = np.sqrt(np.maximum(0.0, 1.0 - np.sum(xyz * xyz, axis=1)))
    quats = np.concatenate([w[:, None], xyz], axis=1)
    opac = _inv_sigmoid(np.clip(alphas_b.astype(np.float32) / 255.0, 1e-6, 1 - 1e-6))
    sh0 = ((colors_b.astype(np.float32) / 255.0) - 0.5).reshape(n, 3) / COLOR_SCALE
    shN = _unquantize_sh(sh_b).reshape(n, sh_dim, 3)

    return GaussianCloud(
        means=means,
        scales=scales.astype(np.float32),
        quats=quats.astype(np.float32),
        opacities=opac.astype(np.float32),
        sh0=sh0.astype(np.float32),
        shN=shN.astype(np.float32),
        antialiased=bool(flags & FLAG_ANTIALIASED),
    )


def load_spz(path_or_file: Union[str, io.IOBase]) -> GaussianCloud:
    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file, "rb") as f:
            data = f.read()
    else:
        data = path_or_file.read()
    return unpack_gaussians(gzip.decompress(data))


def rotate_180_about_x(cloud: GaussianCloud) -> GaussianCloud:
    """RUB <-> RDF coordinate conversion (mirrors splat-types.h rotate180DegAboutX).

    Negates y/z positions, applies the equivalent quaternion transform, and flips the
    SH coefficients that reference the y and z axes.
    """
    g = cloud.to_numpy()
    means = g.means * np.array([1.0, -1.0, -1.0], dtype=np.float32)
    w, x, y, z = g.quats[:, 0], g.quats[:, 1], g.quats[:, 2], g.quats[:, 3]
    s = np.where(x < 0.0, -1.0, 1.0).astype(np.float32)
    quats = np.stack([s * x, -s * w, s * z, -s * y], axis=1)  # wxyz out
    shN = g.shN.copy()
    coeffs_to_invert = [0, 1, 3, 6, 8, 10, 11, 13]
    for j in coeffs_to_invert:
        if j < shN.shape[1]:
            shN[:, j, :] = -shN[:, j, :]
    return GaussianCloud(
        means=means,
        scales=g.scales,
        quats=quats,
        opacities=g.opacities,
        sh0=g.sh0,
        shN=shN,
        antialiased=cloud.antialiased,
    )

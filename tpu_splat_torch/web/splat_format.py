"""GaussianCloud -> packed web-viewer buffer (the port of
tpu_splat/web/splat_format.py; host numpy, byte-identical output).

The browser viewer consumes a flat 32-byte-per-splat little-endian buffer
(the de-facto ".splat" web format: position 3xf32, scale 3xf32 (linear),
color RGBA u8 (SH DC -> color, alpha = sigmoid(opacity)), rotation
quaternion 4xu8 stored wxyz). Only the DC colour band ships to the browser.

Splats are pre-sorted by descending opacity*volume so the viewer can draw a
prefix (progressive loading) and still show the dominant structure.
"""

from __future__ import annotations

import numpy as np

from tpu_splat_torch.core.types import GaussianCloud, to_numpy

SH_C0 = 0.282095
BYTES_PER_SPLAT = 32


def cloud_to_splat_bytes(cloud: GaussianCloud, max_splats: int = 0) -> bytes:
    """Pack a GaussianCloud into the 32-byte web-viewer format."""
    n = cloud.num_points
    means = np.asarray(to_numpy(cloud.means), np.float32)
    scales = np.exp(np.asarray(to_numpy(cloud.scales), np.float32))
    quats = np.asarray(to_numpy(cloud.quats), np.float32)
    quats = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    opac = 1.0 / (1.0 + np.exp(-np.asarray(to_numpy(cloud.opacities), np.float32)))
    rgb = 0.5 + SH_C0 * np.asarray(to_numpy(cloud.sh0), np.float32)

    # dominant-first ordering: opacity * mean scale ~ visual mass
    weight = opac * scales.mean(axis=1)
    order = np.argsort(-weight, kind="stable")
    if max_splats:
        order = order[:max_splats]
        n = len(order)

    buf = np.zeros((n, BYTES_PER_SPLAT), np.uint8)
    f32 = buf[:, :24].view(np.float32).reshape(n, 6)
    f32[:, 0:3] = means[order]
    f32[:, 3:6] = scales[order]
    buf[:, 24:27] = np.clip(rgb[order] * 255.0, 0, 255).astype(np.uint8)
    buf[:, 27] = np.clip(opac[order] * 255.0, 0, 255).astype(np.uint8)
    buf[:, 28:32] = np.clip(quats[order] * 127.5 + 127.5, 0, 255).astype(np.uint8)  # wxyz
    return buf.tobytes()


def splat_bytes_to_arrays(data: bytes):
    """Decode the packed format back to arrays (testing / tooling)."""
    buf = np.frombuffer(bytearray(data), np.uint8).reshape(-1, BYTES_PER_SPLAT)
    n = buf.shape[0]
    f32 = buf[:, :24].view(np.float32).reshape(n, 6)
    means = f32[:, 0:3].copy()
    scales = f32[:, 3:6].copy()
    rgba = buf[:, 24:28].astype(np.float32) / 255.0
    quats = (buf[:, 28:32].astype(np.float32) - 127.5) / 127.5
    return means, scales, rgba, quats

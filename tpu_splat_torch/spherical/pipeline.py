"""360-degree capture expansion: equirectangular frames -> SfM-ready perspective
view sequence (the port of tpu_splat/spherical/pipeline.py).

Functional port of the reference's ERP->perspective optimizer
(equirectangular_to_perspective.py): each ERP frame expands into cube-face
perspective views (faces can be removed, e.g. "down" to drop the tripod), with
"connective" intermediate-angle views inserted at key frames so sequential
matching can bridge between faces, and a final face-major ordering with
direction reversals (Left -> Front(reversed) -> Right -> Back(reversed) -> Up ->
Down(reversed), :127,:752-1472) that keeps consecutive outputs visually adjacent.

The (frame, yaw, pitch) sequence is built first, on the host, in the
reference's order; the views are then rendered on the device in batches,
each batch one gather from the frames it reads.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.spherical.projections import erp_to_perspective, rotation_yaw_pitch

_FACE_YAW = {"front": 0.0, "right": 90.0, "back": 180.0, "left": -90.0}
# Horizontal connective angles between adjacent faces (the reference's
# 15/30/45/60-degree ladder, equirectangular_to_perspective.py:448-750).
_CONNECTIVE_STEPS = (15.0, 30.0, 45.0, 60.0, 75.0)
# output pixels rendered per gather (bounds the batch's index tensors)
_PIXELS_PER_BATCH = 1 << 24


def _key_frame_indices(n: int) -> List[int]:
    """12 key positions: 0%,10%..90%, midpoint, end (the reference's node frames)."""
    fracs = [i / 10 for i in range(10)] + [0.5, 1.0]
    idx = sorted({min(int(round(f * (n - 1))), n - 1) for f in fracs})
    return idx


def view_sequence(n: int, cfg) -> List[Tuple[int, float, float]]:
    """The expansion's (source frame, yaw, pitch) views of n ERP frames, in
    the reference's output order. cfg: SphericalCameraConfig."""
    removed = {
        f.strip().lower()
        for f in (cfg.cube_faces_to_remove or "").split(",")
        if f.strip()
    }
    horiz_faces = [f for f in ("left", "front", "right", "back") if f not in removed]
    key_frames = set(_key_frame_indices(n))

    # Oval nodes (get_oval_node_paths, equirectangular_to_perspective.py:353):
    # connective views at a key frame cycle their SOURCE frame through
    # [center, prev, center, next] per angle index, adding temporal baseline
    # (an elliptical camera path) that stiffens SfM convergence. Out-of-range
    # neighbors fall back to the center frame (the reference's validate path).
    use_oval = getattr(cfg, "use_oval_nodes", False)

    def oval_source(fi: int, angle_idx: int) -> int:
        if not use_oval:
            return fi
        cycle = (fi, max(fi - 1, 0), fi, min(fi + 1, n - 1))
        return cycle[angle_idx % 4]

    # Face-major ordering with reversal rules: each face walks the capture
    # path, alternating direction to stay continuous at face boundaries.
    views: List[Tuple[int, float, float]] = []
    order = list(range(n))
    for i, face in enumerate(horiz_faces):
        yaw = _FACE_YAW[face]
        frames = order if i % 2 == 0 else order[::-1]
        for fi in frames:
            views.append((fi, yaw, 0.0))
            # connective views toward the next face at key frames
            if (fi in key_frames and cfg.optimize_sequential_frame_order
                    and i + 1 < len(horiz_faces)):
                next_yaw = _FACE_YAW[horiz_faces[i + 1]]
                delta = ((next_yaw - yaw + 540) % 360) - 180
                for k, step in enumerate(_CONNECTIVE_STEPS[:4]):
                    views.append((oval_source(fi, k), yaw + math.copysign(step, delta), 0.0))

    pitches_up = (40.0, 75.0) if getattr(cfg, "angled_up_views", False) else (75.0,)
    pitches_down = (-40.0, -75.0) if getattr(cfg, "angled_down_views", False) else (-75.0,)
    if "up" not in removed:
        for fi in sorted(key_frames):
            views += [(fi, 0.0, p) for p in pitches_up]
    if "down" not in removed:
        for fi in sorted(key_frames, reverse=True):
            views += [(fi, 0.0, p) for p in pitches_down]
    return views


def expand_equirectangular_captures(
    images: np.ndarray,
    cfg,
    face_size: int = 0,
    fov_deg: float = 90.0,
    device=None,
) -> np.ndarray:
    """images: (N, H, W, 3) ERP frames. cfg: SphericalCameraConfig. Returns the
    expanded, sequence-ordered perspective image stack, rendered on `device`
    (CUDA unless the CPU is asked for)."""
    dev = resolve_device(device)
    n, h = images.shape[:2]
    face_size = face_size or max(h // 2, 256)
    views = view_sequence(n, cfg)
    rots = np.stack([rotation_yaw_pitch(yaw, pitch) for _, yaw, pitch in views])
    rots = torch.as_tensor(rots.astype(np.float32))
    src = np.array([fi for fi, _, _ in views])
    per_batch = max(1, _PIXELS_PER_BATCH // (face_size * face_size))
    out = np.empty((len(views), face_size, face_size, images.shape[-1]), np.float32)
    with torch.no_grad():
        for s in range(0, len(views), per_batch):
            # upload only the frames this batch reads
            used, local = np.unique(src[s:s + per_batch], return_inverse=True)
            erp = torch.as_tensor(np.ascontiguousarray(images[used], np.float32), device=dev)
            out[s:s + per_batch] = erp_to_perspective(
                erp, rots[s:s + per_batch], face_size, face_size, fov_deg,
                frames=torch.as_tensor(local)).cpu().numpy()
    return out

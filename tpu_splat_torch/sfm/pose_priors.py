"""Pose-prior import and triangulation with fixed poses (the port of
tpu_splat/sfm/pose_priors.py).

The reference's pose-prior path (process_pose_transforms.py +
extract_poses_imgs.py + colmap point_triangulator, main.py:1090-1113):

- Convert 4x4 poses from ARKit / ARCore / OpenGL / OpenCV / ROS conventions into
  the pipeline's OpenCV camera convention (basis-change matrices identical to
  pose_to_colmap_matrix, process_pose_transforms.py:281-371).
- Normalize pose translations to unit-ish scale (normalize_poses :258).
- Parse NeRFCapture-style transforms.json archives (transforms-in.json with
  per-frame transform_matrix).
- Triangulate scene points with poses held fixed (the point_triangulator
  analog): the incremental mapper's features, matching and tracks on the
  device, then batched multi-view DLT and a bundle refinement.

The conversions are host numpy in f64, copied from the reference.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

# Basis-change matrices to the OpenCV/COLMAP camera convention.
CONVENTIONS: Dict[str, np.ndarray] = {
    "arkit": np.diag([1.0, -1.0, -1.0, 1.0]),
    "arcore": np.diag([1.0, 1.0, -1.0, 1.0]),
    "opengl": np.diag([1.0, -1.0, -1.0, 1.0]),
    "opencv": np.eye(4),
    "ros": np.array(
        [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1.0]]
    ),
}


def convert_pose(
    matrix: np.ndarray, source: str, is_world_to_cam: bool
) -> np.ndarray:
    """Source-convention 4x4 pose -> camera-to-world in OpenCV convention."""
    source = source.lower()
    if source not in CONVENTIONS:
        raise ValueError(
            f"pose coordinate name {source!r} not supported "
            "(arkit, arcore, opengl, opencv, ros)"
        )
    T = CONVENTIONS[source]
    m = T @ matrix @ T.T
    if is_world_to_cam:
        R = m[:3, :3]
        t = m[:3, 3]
        out = np.eye(4)
        out[:3, :3] = R.T
        out[:3, 3] = -R.T @ t
        return out
    return m


def normalize_poses(c2ws: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """Center camera positions on the origin, scale max extent to ~1 (+10%)."""
    centers = c2ws[:, :3, 3]
    centroid = centers.mean(axis=0)
    scale = float(np.max(np.abs(centers - centroid))) * 1.1
    scale = max(scale, 1e-9)
    out = c2ws.copy()
    out[:, :3, 3] = (centers - centroid) / scale
    return out, centroid, scale


def load_transforms_json(path: str, source: str = "arkit",
                         is_world_to_cam: bool = True):
    """Parse a NeRFCapture/Nerfstudio-style transforms(-in).json.

    Returns (c2ws (N,4,4) OpenCV convention, intrinsics dict, frame file names)."""
    with open(path) as f:
        data = json.load(f)
    frames = data.get("frames", [])
    c2ws, names = [], []
    for fr in frames:
        m = np.array(fr["transform_matrix"], np.float64)
        c2ws.append(convert_pose(m, source, is_world_to_cam))
        names.append(os.path.basename(fr.get("file_path", f"{len(names):05d}.png")))
    intrin = {
        "fx": float(data.get("fl_x", data.get("fx", 0.0))),
        "fy": float(data.get("fl_y", data.get("fy", 0.0))),
        "cx": float(data.get("cx", 0.0)),
        "cy": float(data.get("cy", 0.0)),
        "w": int(data.get("w", 0)),
        "h": int(data.get("h", 0)),
    }
    return np.stack(c2ws), intrin, names


def sfm_with_pose_priors(
    images: np.ndarray,
    c2ws: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    mapper_cfg=None,
    refine_poses: bool = True,
    log_fn=None,
    device=None,
):
    """Triangulate a sparse cloud with known (prior) camera poses, on
    `device` (CUDA unless the CPU is asked for).

    The point_triangulator analog: runs feature extraction + matching + track
    building from the incremental mapper, then triangulates every track against
    the fixed prior poses; optionally a final BA refines poses slightly
    (refine_intrinsics-style polish) around the priors."""
    from tpu_splat_torch.sfm.mapper import IncrementalMapper, MapperConfig

    cfg = mapper_cfg or MapperConfig()
    m = IncrementalMapper(images, cfg, fx=fx, fy=fy, cx=cx, cy=cy, log_fn=log_fn,
                          device=device)
    m.extract_all()
    m.match_all()
    m.build_tracks()

    n = images.shape[0]
    w2c = np.linalg.inv(c2ws)
    m.R = w2c[:, :3, :3].astype(np.float32)
    m.t = w2c[:, :3, 3].astype(np.float32)
    m.registered = np.ones(n, bool)
    n_tracks = len(m.tracks)
    m.points = np.zeros((n_tracks, 3), np.float32)
    m.has_point = np.zeros(n_tracks, bool)
    m._attempts = np.zeros(n, np.int32)
    m._retriangulate()
    if refine_poses:
        m._bundle_adjust()
        m._filter_observations()
        m._retriangulate()
    m._filter_points()
    scene = m._to_scene()
    m._log_timers("done")
    return scene

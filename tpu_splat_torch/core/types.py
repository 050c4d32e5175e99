"""Core data types (the port's counterpart of tpu_splat/core/types.py).

Plain dataclasses over numpy arrays or torch tensors; the JAX package's flax
`struct` pytrees have no role here. Conventions are the reference's:

- Camera poses are camera-to-world 4x4 matrices, OpenCV convention (+x right,
  +y down, +z forward).
- Gaussian rotations are quaternions in wxyz order; scales are log-scales;
  opacities are pre-sigmoid logits.
- shN is (N, K, 3), coefficient-major with RGB innermost, K in {0, 3, 8, 15}.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class CameraModel(enum.Enum):
    """Supported camera models (subset of COLMAP's model zoo that the pipeline uses)."""

    SIMPLE_PINHOLE = "SIMPLE_PINHOLE"  # f, cx, cy
    PINHOLE = "PINHOLE"  # fx, fy, cx, cy
    SIMPLE_RADIAL = "SIMPLE_RADIAL"  # f, cx, cy, k1
    OPENCV = "OPENCV"  # fx, fy, cx, cy, k1, k2, p1, p2


SH_DIM_FOR_DEGREE = {0: 0, 1: 3, 2: 8, 3: 15}


def sh_degree_for_dim(dim: int) -> int:
    """Map a per-channel SH rest-coefficient count to an SH degree."""
    if dim < 3:
        return 0
    if dim < 8:
        return 1
    if dim < 15:
        return 2
    return 3


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device, autograd detached) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class Cameras:
    """A batch of cameras sharing one (width, height) image plane.

    camtoworlds: (N, 4, 4) camera-to-world, OpenCV convention.
    fx, fy, cx, cy: (N,) intrinsics in pixels.
    distortion: (N, 4) [k1, k2, p1, p2] (zeros = pinhole).
    """

    camtoworlds: np.ndarray
    fx: np.ndarray
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    distortion: np.ndarray
    width: int = 0
    height: int = 0

    def __len__(self) -> int:
        return self.camtoworlds.shape[0]

    @property
    def worldtocams(self) -> np.ndarray:
        """(N, 4, 4) world-to-camera matrices (inverse of SE(3) camtoworlds).

        -R^T t is summed in the reference's order, a chain of fused
        multiply-adds (each product added exactly, one rounding per step), so
        the poses the port exports are byte-equal to the reference's."""
        c2w = to_numpy(self.camtoworlds)
        R = c2w[..., :3, :3]
        t = c2w[..., :3, 3]
        Rt = np.swapaxes(R, -1, -2)
        acc = np.zeros(t.shape, c2w.dtype)
        for j in range(3):
            acc = (acc.astype(np.float64)
                   + Rt[..., :, j].astype(np.float64) * t[..., None, j]).astype(c2w.dtype)
        t_inv = -acc
        w2c = np.zeros(c2w.shape, c2w.dtype)
        w2c[..., :3, :3] = Rt
        w2c[..., :3, 3] = t_inv
        w2c[..., 3, 3] = 1.0
        return w2c


@dataclass
class GaussianCloud:
    """A 3D Gaussian splat model (the interchange type).

    means (N, 3); scales (N, 3) log-scales; quats (N, 4) wxyz; opacities (N,)
    logits; sh0 (N, 3) DC; shN (N, K, 3) SH rest coefficients.
    """

    means: np.ndarray
    scales: np.ndarray
    quats: np.ndarray
    opacities: np.ndarray
    sh0: np.ndarray
    shN: np.ndarray
    antialiased: bool = False

    @property
    def num_points(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return sh_degree_for_dim(self.shN.shape[1])

    def to_numpy(self) -> "GaussianCloud":
        return GaussianCloud(
            means=to_numpy(self.means),
            scales=to_numpy(self.scales),
            quats=to_numpy(self.quats),
            opacities=to_numpy(self.opacities),
            sh0=to_numpy(self.sh0),
            shN=to_numpy(self.shN),
            antialiased=self.antialiased,
        )


@dataclass
class SfMScene:
    """Output of structure-from-motion: registered cameras + sparse points.

    points (P, 3); point_colors (P, 3); point_errors (P,); track_counts (P,);
    registered (N,) bool mask over the input image list.
    """

    cameras: Cameras
    points: np.ndarray
    point_colors: np.ndarray
    point_errors: np.ndarray
    track_counts: np.ndarray
    registered: np.ndarray

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

"""Blur filtering: variance-of-Laplacian sharpness scoring + two-phase frame
selection (the port's copy of tpu_splat/ingest/blur.py, host numpy and cv2).

A port of filter_blurry_images.py: the per-frame Laplacian-variance scores
(compute_laplacian_variance_basic, :339) are computed with cv2 per frame, and
the two-phase selection (select_frames, :525 — best-per-small-period, then
fill per-large-period while invalidating +-spacing/2 neighbors) and
equidistant reduction (reduce_images_to_target, :81) are ported as index
logic. The saliency-masked scoring is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def laplacian_variance(images: np.ndarray, chunk: int = 32) -> np.ndarray:
    """Sharpness score per image; images (N, H, W[, 3]) float32 in [0,1].

    Host-side, as in the reference: this is ingest preprocessing, one cv2
    3x3 Laplacian per frame. Same 4-neighbor kernel as the reference (compute_laplacian_variance_basic, filter_blurry_images.py:339),
    border cropped to match a VALID convolution."""
    import cv2

    if images.ndim == 4:
        gray = images @ np.array([0.299, 0.587, 0.114], np.float32)
    else:
        gray = images
    return np.array([
        cv2.Laplacian(np.ascontiguousarray(g, np.float32),
                      cv2.CV_32F, ksize=1)[1:-1, 1:-1].var()
        for g in gray
    ], np.float32)


# where the saliency-masked scoring (it needs the matting stack) is queued
_SALIENCY_ITEM = "ROADMAP.md queue 1 item 11 (matting)"


def saliency_laplacian_variance(
    images: np.ndarray,
    model: str = "u2net",
    decay_frames: float = 30.0,
    threshold: float = 0.5,
) -> np.ndarray:
    """Saliency-masked sharpness scoring (the reference's
    blur.saliency_laplacian_variance) scores only the salient subject, with
    masks from the matting stack, which the port does not have yet."""
    raise NotImplementedError(
        f"blur mask method {model!r} needs the matting stack, not ported yet: {_SALIENCY_ITEM}")


def select_sharp_frames(
    scores: np.ndarray,
    target_count: int,
    small_period: Optional[int] = None,
    large_period: Optional[int] = None,
) -> np.ndarray:
    """Two-phase selection of sharp frames, preserving temporal coverage.

    Phase 1: keep the sharpest frame in each small period (local best).
    Phase 2: fill remaining budget with the globally sharpest unselected frames,
    invalidating +-spacing/2 neighbors of each pick so selections stay spread out.
    Returns sorted indices of the selected frames.
    """
    n = len(scores)
    if target_count >= n:
        return np.arange(n)
    small = small_period or max(n // target_count, 1)
    selected: List[int] = []
    for start in range(0, n, small):
        seg = scores[start : start + small]
        selected.append(start + int(np.argmax(seg)))
    if len(selected) > target_count:
        return reduce_equidistant(np.array(sorted(selected)), target_count)

    # phase 2: fill with spread-out sharp frames
    spacing = large_period or small
    blocked = np.zeros(n, bool)
    for s in selected:
        lo, hi = max(0, s - spacing // 2), min(n, s + spacing // 2 + 1)
        blocked[lo:hi] = True
    order = np.argsort(-scores)
    for idx in order:
        if len(selected) >= target_count:
            break
        if blocked[idx]:
            continue
        selected.append(int(idx))
        lo, hi = max(0, idx - spacing // 2), min(n, idx + spacing // 2 + 1)
        blocked[lo:hi] = True
    return np.array(sorted(set(selected)))


def reduce_equidistant(indices: np.ndarray, target: int) -> np.ndarray:
    """Reduce a sorted index list to `target` entries, evenly spaced."""
    if len(indices) <= target:
        return indices
    pick = np.linspace(0, len(indices) - 1, target).round().astype(int)
    return indices[np.unique(pick)]


def filter_blurry_images(
    images: np.ndarray,
    target_count: Optional[int] = None,
    min_keep_fraction: float = 0.5,
    mask_method: str = "full",
) -> Tuple[np.ndarray, np.ndarray]:
    """Score + select sharp frames. Returns (selected_images, selected_indices).

    mask_method: "full" scores the whole frame; a u2net model name scores only
    the salient subject (compute_laplacian_variance dispatch,
    filter_blurry_images.py:499-519)."""
    if mask_method and mask_method not in ("full", "center"):
        scores = saliency_laplacian_variance(images, model=mask_method)
    else:
        scores = laplacian_variance(images)
    n = len(images)
    target = target_count if target_count is not None else max(int(n * min_keep_fraction), 3)
    target = min(target, n)
    idx = select_sharp_frames(scores, target)
    return images[idx], idx

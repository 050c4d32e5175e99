"""Blur filtering: variance-of-Laplacian sharpness scoring + two-phase frame
selection (the port's copy of tpu_splat/ingest/blur.py, host numpy and cv2).

A port of filter_blurry_images.py: the per-frame Laplacian-variance scores
(compute_laplacian_variance_basic, :339) are computed with cv2 per frame, and
the two-phase selection (select_frames, :525 — best-per-small-period, then
fill per-large-period while invalidating +-spacing/2 neighbors) and
equidistant reduction (reduce_images_to_target, :81) are ported as index
logic. The saliency-masked scoring takes its masks from the matting nets.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from tpu_splat_torch.core.device import resolve_device


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


def saliency_laplacian_variance(
    images: np.ndarray,
    model: str = "u2net",
    decay_frames: float = 30.0,
    threshold: float = 0.5,
    device=None,
) -> np.ndarray:
    """Saliency-masked sharpness scoring with temporally smoothed masks — the
    object-capture mode (compute_laplacian_variance_u2net,
    filter_blurry_images.py:205-339): score only the salient subject so frame
    selection keeps the SUBJECT sharp, with the per-frame mask low-pass
    filtered through time (single-pole recursive filter, the reference's
    decay_s * fps) after warping the previous filtered mask forward along
    Farneback optical flow.

    The masks come from the matting nets on `device` (CUDA unless the CPU is
    asked for); the flow, the filter and the scores stay cv2 on the host.
    images (N, H, W, 3) float32 in [0,1]; returns (N,) scores."""
    import cv2

    from tpu_splat_torch.matting.matnet import matnet_saliency
    from tpu_splat_torch.matting.remove import (_find_u2net_weights, _saliency_mask,
                                                _u2net_masks)

    dev = resolve_device(device)
    n = len(images)
    weights = _find_u2net_weights() if model.startswith("u2net") else None
    masks = None
    if weights is not None:
        masks = np.asarray(_u2net_masks(images, weights, dev), np.float32)
    if masks is None:  # bundled MatNet (learned, no downloads)
        masks = matnet_saliency(images, device=dev)
    if masks is None:  # classical saliency fallback (same stack as bg removal)
        # Copied quirk: the reference hands _saliency_mask the frame as
        # uint8 (0-255), which it clips to [0, 1], as here.
        masks = np.stack([
            _saliency_mask((img * 255).astype(np.uint8)) for img in images
        ]).astype(np.float32)

    gray = (images @ np.array([0.299, 0.587, 0.114], np.float32) * 255).astype(
        np.uint8
    )
    x = float(np.exp(-1.0 / decay_frames)) if decay_frames > 0 else 0.0

    scores = np.zeros(n, np.float32)
    mask_f = None
    flow = None
    for f in range(n):
        m = masks[f]
        if x > 0.0 and mask_f is not None:
            flow = cv2.calcOpticalFlowFarneback(
                gray[f], gray[f - 1], flow, 0.5, 3, 15, 3, 5, 1.2, 0
            )
            fmap = flow.copy()
            fmap[:, :, 0] += np.arange(fmap.shape[1])
            fmap[:, :, 1] += np.arange(fmap.shape[0])[:, np.newaxis]
            warped = cv2.remap(mask_f, fmap, None, cv2.INTER_LINEAR)
            m = (1 - x) * m + x * warped
        mask_f = m.astype(np.float32)
        lap = cv2.Laplacian(gray[f].astype(np.float32) / 255.0, cv2.CV_32F)
        sel = lap[mask_f > threshold]
        # an empty mask falls back to full-frame variance rather than zero
        scores[f] = float(sel.var()) if sel.size > 64 else float(lap.var())
    return scores


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
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Score + select sharp frames. Returns (selected_images, selected_indices).

    mask_method: "full" scores the whole frame; a u2net model name scores only
    the salient subject (compute_laplacian_variance dispatch,
    filter_blurry_images.py:499-519), with the matting nets on `device`."""
    if mask_method and mask_method not in ("full", "center"):
        scores = saliency_laplacian_variance(images, model=mask_method, device=device)
    else:
        scores = laplacian_variance(images)
    n = len(images)
    target = target_count if target_count is not None else max(int(n * min_keep_fraction), 3)
    target = min(target, n)
    idx = select_sharp_frames(scores, target)
    return images[idx], idx

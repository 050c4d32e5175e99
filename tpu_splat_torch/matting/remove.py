"""Background removal front end (the port of tpu_splat/matting/remove.py).

Maps the reference's segmentation options (remove_background.py /
remove_background_sam2.py) to native implementations:

- "u2net" / "u2net_human_seg": U2Net when a standard PyTorch checkpoint is
  available (TPU_SPLAT_U2NET_WEIGHTS env var or ~/.tpu_splat/u2net.pth);
  otherwise the bundled MatNet (matting/matnet.py); classical saliency
  (spectral residual + GrabCut + center prior) remains the last resort.
  These are choices between models, not between devices.
- "sam2": video-mode propagation — per-frame learned masks fused with the
  previous mask warped forward along dense optical flow, echoing the SAM2
  video predictor's keyframe+propagation structure
  (remove_background_sam2.py:47-305) without its 2.3 GB checkpoint.

The nets and their resizes run on the device; GrabCut, connected
components, morphology and Farneback flow stay cv2 and numpy on the host,
as in the reference. Mask post-processing (threshold -> largest component ->
morphology close/open) ports clean_mask (remove_background_sam2.py:268-305).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device

_U2NET_BATCH = 4  # frames per U2Net pass


def _find_u2net_weights() -> Optional[str]:
    cand = os.environ.get("TPU_SPLAT_U2NET_WEIGHTS")
    if cand and os.path.exists(cand):
        return cand
    home = os.path.expanduser("~/.tpu_splat/u2net.pth")
    return home if os.path.exists(home) else None


def _saliency_mask(img: np.ndarray) -> np.ndarray:
    """Weight-free saliency: spectral residual + center prior, [0,1] float."""
    import cv2

    gray = (np.clip(img, 0, 1).mean(-1) * 255).astype(np.uint8)
    small = cv2.resize(gray, (128, 128))
    f = np.fft.fft2(small.astype(np.float32))
    log_amp = np.log1p(np.abs(f))
    phase = np.angle(f)
    kernel = np.ones((3, 3), np.float32) / 9
    smooth = cv2.filter2D(log_amp, -1, kernel)
    resid = log_amp - smooth
    sal = np.abs(np.fft.ifft2(np.exp(resid + 1j * phase))) ** 2
    sal = cv2.GaussianBlur(sal.astype(np.float32), (9, 9), 2.5)
    sal = (sal - sal.min()) / max(sal.max() - sal.min(), 1e-9)

    # border-contrast prior: distance from the mean border color (flat-colored
    # subjects have no spectral-residual response, but still differ from the
    # background that dominates the image border)
    rgb_small = cv2.resize(np.clip(img, 0, 1).astype(np.float32), (128, 128))
    border = np.concatenate([
        rgb_small[:6].reshape(-1, 3), rgb_small[-6:].reshape(-1, 3),
        rgb_small[:, :6].reshape(-1, 3), rgb_small[:, -6:].reshape(-1, 3),
    ])
    bg_color = np.median(border, axis=0)
    contrast = np.linalg.norm(rgb_small - bg_color, axis=-1)
    contrast = (contrast - contrast.min()) / max(contrast.max() - contrast.min(), 1e-9)

    sal = 0.5 * sal + 0.5 * contrast
    # center prior
    yy, xx = np.mgrid[0:128, 0:128]
    center = np.exp(-(((yy - 64) / 64) ** 2 + ((xx - 64) / 64) ** 2))
    sal = sal * (0.3 + 0.7 * center)
    sal = (sal - sal.min()) / max(sal.max() - sal.min(), 1e-9)
    return cv2.resize(sal, (img.shape[1], img.shape[0]))


def _grabcut_refine(img: np.ndarray, sal: np.ndarray, threshold: float) -> np.ndarray:
    import cv2

    h, w = sal.shape
    small_dim = 480
    scale = min(small_dim / max(h, w), 1.0)
    sw, sh = int(w * scale), int(h * scale)
    img8 = (np.clip(cv2.resize(img, (sw, sh)), 0, 1) * 255).astype(np.uint8)
    sal_s = cv2.resize(sal, (sw, sh))
    # Adaptive seeding: the saliency scale varies per image, so a fixed cut
    # starves GrabCut of foreground seeds. Otsu on the saliency histogram
    # separates the subject mode; `threshold` biases it (higher -> stricter).
    otsu, _ = cv2.threshold(
        (sal_s * 255).astype(np.uint8), 0, 255,
        cv2.THRESH_BINARY + cv2.THRESH_OTSU,
    )
    t = float(otsu) / 255.0 * (0.5 + threshold)
    mask = np.full((sh, sw), cv2.GC_PR_BGD, np.uint8)
    mask[sal_s > t] = cv2.GC_PR_FGD
    mask[sal_s > min(0.5 * (t + sal_s.max()), 0.95)] = cv2.GC_FGD
    mask[sal_s < 0.3 * t] = cv2.GC_BGD
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    try:
        cv2.grabCut(img8, mask, None, bgd, fgd, 3, cv2.GC_INIT_WITH_MASK)
    except cv2.error:
        return (sal > threshold).astype(np.float32)
    out = ((mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD)).astype(np.float32)
    return cv2.resize(out, (w, h), interpolation=cv2.INTER_NEAREST)


def clean_mask(mask: np.ndarray, min_area_frac: float = 0.001) -> np.ndarray:
    """Largest connected component + morphological close/open
    (remove_background_sam2.py clean_mask port)."""
    import cv2

    m = (mask > 0.5).astype(np.uint8)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(m)
    if n > 1:
        areas = stats[1:, cv2.CC_STAT_AREA]
        keep = 1 + int(np.argmax(areas))
        m = (labels == keep).astype(np.uint8)
    k = np.ones((7, 7), np.uint8)
    m = cv2.morphologyEx(m, cv2.MORPH_CLOSE, k)
    m = cv2.morphologyEx(m, cv2.MORPH_OPEN, np.ones((3, 3), np.uint8))
    return m.astype(np.float32)


def apply_mask_images(
    images: np.ndarray, mask_images: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Remove the region marked by externally supplied mask images.

    Ports the remove_object_using_mask.py contract (reference
    remove_object_using_mask.py:28-169): the grayscale mask marks the object to
    REMOVE (white = object); it is inverted, any nonzero pixel of the inversion
    becomes opaque, and the result is normalized to {0,1} with an Otsu
    threshold — so anti-aliased or 16-bit masks binarize the same way the
    reference's cv2.THRESH_OTSU pass does. Returns (masked_images, keep_masks),
    keep_masks float32 in {0,1} with 1 = scene kept.

    images: (N, H, W, 3) float32 [0,1]; mask_images: (N, H, W[, C]) any dtype.
    """
    import cv2

    if images.shape[:3] != np.asarray(mask_images).shape[:3]:
        raise ValueError(
            f"images {images.shape[:3]} and masks "
            f"{np.asarray(mask_images).shape[:3]} must share (N, H, W)"
        )
    keeps = np.zeros(images.shape[:3], np.float32)
    for i, m in enumerate(mask_images):
        m = np.asarray(m)
        if m.ndim == 3:
            m = m.mean(axis=-1)
        m = m.astype(np.float32)
        if m.max() > 1.0:
            m = m / (65535.0 if m.max() > 255.0 else 255.0)
        inv = 1.0 - np.clip(m, 0.0, 1.0)
        # black_to_alpha: fully-black pixels of the inverted mask stay removed
        # regardless of where Otsu lands (they are the object's core).
        inv8 = (inv * 255.0 + 0.5).astype(np.uint8)
        if inv8.min() == inv8.max():  # constant mask: Otsu undefined
            keeps[i] = float(inv8.max() > 0)
            continue
        _, binary = cv2.threshold(
            inv8, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU
        )
        keeps[i] = (binary > 0).astype(np.float32) * (inv8 > 0)
    masked = (images * keeps[..., None]).astype(np.float32)
    return masked, keeps


def _u2net_masks(images: np.ndarray, weights_path: str, device) -> np.ndarray:
    """Full U2Net saliency (N, H, W) of `images` from a standard PyTorch
    checkpoint, 4 frames a pass on `device`."""
    from tpu_splat_torch.matting.u2net import load_u2net, u2net_apply

    net = load_u2net(weights_path, device)
    out = []
    with torch.no_grad():
        for i in range(0, len(images), _U2NET_BATCH):
            batch = torch.as_tensor(
                np.ascontiguousarray(images[i:i + _U2NET_BATCH], np.float32), device=device)
            out.append(u2net_apply(net, batch).cpu().numpy())
    return np.concatenate(out)


def remove_background_batch(
    images: np.ndarray,
    model: str = "u2net",
    threshold: float = 0.6,
    keyframe_every: int = 8,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (masked_images, masks). Masked pixels are zeroed (the pipeline
    also keeps the mask for loss weighting). The nets run on `device` (CUDA
    unless the CPU is asked for)."""
    import cv2

    from tpu_splat_torch.matting.matnet import matnet_saliency

    dev = resolve_device(device)
    n = len(images)
    weights = _find_u2net_weights()
    masks = np.zeros(images.shape[:3], np.float32)

    def _keyframe_mask(img: np.ndarray, sal: Optional[np.ndarray]) -> np.ndarray:
        """Best available single-frame subject mask: the frame's MatNet
        saliency when there is one, classical saliency+GrabCut otherwise."""
        if sal is not None:
            return clean_mask((sal > 0.5).astype(np.float32))
        return clean_mask(_grabcut_refine(img, _saliency_mask(img), threshold))

    if model in ("u2net", "u2net_human_seg") and weights:
        sal = _u2net_masks(images, weights, dev)
        for i in range(n):
            masks[i] = clean_mask(_grabcut_refine(images[i], sal[i], threshold))
    elif model in ("u2net", "u2net_human_seg"):
        sal_all = matnet_saliency(images, device=dev)
        for i in range(n):
            masks[i] = _keyframe_mask(images[i], None if sal_all is None else sal_all[i])
    elif model == "sam2":
        # Video mode: per-frame learned prediction fused with the previous
        # mask warped forward along dense optical flow — the memory-
        # conditioned structure of the SAM2 video predictor (each frame is
        # segmented UNDER the memory of previous masks,
        # remove_background_sam2.py:76-124), not mere keyframe interpolation.
        # Without the learned net (no bundled weights), keyframes fall back
        # to saliency+GrabCut and intermediate frames ride the warp alone.
        sal_all = matnet_saliency(images, device=dev)
        prev_gray = None
        prev_mask = None
        for i in range(n):
            gray = (np.clip(images[i], 0, 1).mean(-1) * 255).astype(np.uint8)
            warped = None
            if prev_mask is not None:
                flow = cv2.calcOpticalFlowFarneback(
                    prev_gray, gray, None, 0.5, 3, 21, 3, 5, 1.1, 0
                )
                h, w = gray.shape
                yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
                map_x = xx - flow[..., 0]
                map_y = yy - flow[..., 1]
                warped = cv2.remap(prev_mask, map_x, map_y, cv2.INTER_LINEAR)
            if sal_all is not None:
                cur = sal_all[i]
                fused = cur if warped is None else 0.65 * cur + 0.35 * warped
                masks[i] = clean_mask((fused > 0.5).astype(np.float32))
            elif i % keyframe_every == 0 or warped is None:
                masks[i] = _keyframe_mask(images[i], None)
            else:
                masks[i] = clean_mask(warped)
            prev_gray = gray
            prev_mask = masks[i]
    else:
        for i in range(n):
            sal = _saliency_mask(images[i])
            masks[i] = clean_mask(_grabcut_refine(images[i], sal, threshold))

    masked = images * masks[..., None]
    return masked.astype(np.float32), masks

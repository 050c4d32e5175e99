"""Procedural composite generator for MatNet training (the port's copy of
tpu_splat/matting/synthdata.py, numpy and cv2 only).

Generates (image, mask) pairs of a dominant textured subject over a distinct
background — the capture regime of the reference's segmentation stage (one
centered object, orbit/turntable video: remove_background_sam2.py's
center-point seeding assumes exactly this). Everything is procedural numpy:
no downloads, no datasets.

Diversity axes: background family (octave noise / plaid / gradient / flat /
checker), subject silhouette (ellipse unions, soft blobs, polygon stars),
subject texture family, relative brightness (subject may be darker OR
lighter), soft shadows, distractor objects (small, off-center, labeled
background), focus blur on either layer, lighting jitter, sensor noise.
"""

from __future__ import annotations

import numpy as np


def _value_noise(rng: np.random.Generator, h: int, w: int,
                 cells: int) -> np.ndarray:
    """Single-octave value noise: a coarse random grid upsampled bilinearly."""
    import cv2

    g = rng.random((cells, cells)).astype(np.float32)
    return cv2.resize(g, (w, h), interpolation=cv2.INTER_CUBIC)


def _octave_noise(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    out = np.zeros((h, w), np.float32)
    amp = 1.0
    for cells in (3, 6, 12, 24):
        out += amp * _value_noise(rng, h, w, cells)
        amp *= 0.55
    out -= out.min()
    return out / max(out.max(), 1e-6)


def _scalar_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    kind = rng.integers(0, 5)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    if kind == 0:
        return _octave_noise(rng, h, w)
    if kind == 1:  # plaid
        fx, fy = rng.uniform(0.02, 0.35, 2)
        px, py = rng.uniform(0, 6.28, 2)
        t = 0.5 + 0.25 * np.sin(xx * fx + px) + 0.25 * np.sin(yy * fy + py)
        return t.astype(np.float32)
    if kind == 2:  # linear gradient
        ang = rng.uniform(0, 6.28)
        t = xx * np.cos(ang) + yy * np.sin(ang)
        t -= t.min()
        return (t / max(t.max(), 1e-6)).astype(np.float32)
    if kind == 3:  # near-flat
        return np.full((h, w), rng.random(), np.float32)
    cell = int(rng.integers(6, 40))  # checker
    return (((yy // cell) + (xx // cell)) % 2).astype(np.float32)


def _colorize(rng: np.random.Generator, t: np.ndarray) -> np.ndarray:
    """Map a [0,1] scalar field through two random anchor colors."""
    c0 = rng.random(3).astype(np.float32)
    c1 = rng.random(3).astype(np.float32)
    return t[..., None] * c1 + (1 - t[..., None]) * c0


def _shape_mask(rng: np.random.Generator, h: int, w: int,
                cx: float, cy: float, scale: float) -> np.ndarray:
    """Soft [0,1] silhouette around (cx, cy), extent ~scale*min(h,w)."""
    import cv2

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = scale * min(h, w) / 2.0
    kind = rng.integers(0, 3)
    if kind == 0:  # union of 1-4 random ellipses
        m = np.zeros((h, w), np.float32)
        for _ in range(int(rng.integers(1, 5))):
            ox, oy = rng.uniform(-0.5, 0.5, 2) * r
            a = r * rng.uniform(0.4, 1.0)
            b = r * rng.uniform(0.4, 1.0)
            ang = rng.uniform(0, 3.14)
            dx = (xx - cx - ox) * np.cos(ang) + (yy - cy - oy) * np.sin(ang)
            dy = -(xx - cx - ox) * np.sin(ang) + (yy - cy - oy) * np.cos(ang)
            m = np.maximum(m, ((dx / a) ** 2 + (dy / b) ** 2 < 1).astype(np.float32))
    elif kind == 1:  # radial-wobble blob
        n_lobe = int(rng.integers(3, 9))
        ph = rng.uniform(0, 6.28)
        amp = rng.uniform(0.1, 0.45)
        theta = np.arctan2(yy - cy, xx - cx)
        rad = np.hypot(xx - cx, yy - cy)
        bound = r * (1 + amp * np.sin(n_lobe * theta + ph))
        m = (rad < bound).astype(np.float32)
    else:  # convex-ish polygon
        n_v = int(rng.integers(3, 8))
        ang = np.sort(rng.uniform(0, 6.28, n_v))
        rad = r * rng.uniform(0.5, 1.0, n_v)
        pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
        m = np.zeros((h, w), np.float32)
        cv2.fillPoly(m, [pts.astype(np.int32)], 1.0)
    # soften the edge a little (anti-aliased alpha)
    return cv2.GaussianBlur(m, (5, 5), 1.2)


def make_composite(rng: np.random.Generator, h: int = 256, w: int = 256):
    """One (image (H,W,3) float32 [0,1], gt_mask (H,W) float32 {0,1})."""
    import cv2

    bg = _colorize(rng, _scalar_texture(rng, h, w))
    if rng.random() < 0.18:
        # CAMOUFLAGE family: the subject carries the background's own palette
        # and texture family, just spatially shifted — contrast exists only at
        # the boundary. Without these samples the net collapses on same-
        # palette subjects (measured r5: IoU 0.037 on the held-out camo
        # composites in tests/test_matting_quality.shifted_scene).
        sy, sx = int(rng.integers(h // 4, 3 * h // 4)), int(
            rng.integers(w // 4, 3 * w // 4))
        fg = np.roll(np.roll(bg, sy, axis=0), sx, axis=1)
        if rng.random() < 0.5:
            fg = fg[::-1].copy()
    else:
        fg = _colorize(rng, _scalar_texture(rng, h, w))
        # push subject/background apart in brightness OR hue so the task is
        # well-posed (the real pipeline's subjects are distinct by construction)
        if rng.random() < 0.5:
            if fg.mean() > bg.mean():
                fg = np.clip(fg * rng.uniform(1.1, 1.6), 0, 1)
                bg = bg * rng.uniform(0.4, 0.85)
            else:
                bg = np.clip(bg * rng.uniform(1.1, 1.6), 0, 1)
                fg = fg * rng.uniform(0.4, 0.85)
        else:
            roll = int(rng.integers(1, 3))
            fg = np.roll(fg, roll, axis=-1)

    cx = w * rng.uniform(0.35, 0.65)
    cy = h * rng.uniform(0.35, 0.65)
    alpha = _shape_mask(rng, h, w, cx, cy, rng.uniform(0.3, 0.75))

    # defocus one layer sometimes (the blur filter consumes these masks too)
    if rng.random() < 0.3:
        k = int(rng.integers(1, 4)) * 2 + 1
        bg = cv2.GaussianBlur(bg, (k, k), 0)
    if rng.random() < 0.15:
        k = int(rng.integers(1, 3)) * 2 + 1
        fg = cv2.GaussianBlur(fg, (k, k), 0)

    # soft contact shadow under the subject
    if rng.random() < 0.5:
        sh = np.roll(alpha, int(rng.integers(2, 10)), axis=0)
        sh = cv2.GaussianBlur(sh, (21, 21), 7.0) * rng.uniform(0.2, 0.5)
        bg = bg * (1 - sh[..., None])

    img = bg * (1 - alpha[..., None]) + fg * alpha[..., None]

    # small off-center distractors belong to the BACKGROUND class: teaches
    # the dominance prior (SAM2's center seeding encodes the same bias)
    for _ in range(int(rng.integers(0, 3))):
        dx = w * (rng.uniform(0.05, 0.2) if rng.random() < 0.5
                  else rng.uniform(0.8, 0.95))
        dy = h * rng.uniform(0.05, 0.95)
        dm = _shape_mask(rng, h, w, dx, dy, rng.uniform(0.05, 0.15))
        dm = dm * (1 - alpha)  # never overwrite the subject
        dtex = _colorize(rng, _scalar_texture(rng, h, w))
        img = img * (1 - dm[..., None]) + dtex * dm[..., None]

    # lighting + sensor noise
    img = np.clip(img * rng.uniform(0.7, 1.2) + rng.uniform(-0.08, 0.08), 0, 1)
    img += rng.normal(0, rng.uniform(0.003, 0.03), img.shape)
    return np.clip(img, 0, 1).astype(np.float32), (alpha > 0.5).astype(np.float32)


def make_batch(rng: np.random.Generator, n: int, h: int = 256, w: int = 256):
    imgs = np.zeros((n, h, w, 3), np.float32)
    masks = np.zeros((n, h, w), np.float32)
    for i in range(n):
        imgs[i], masks[i] = make_composite(rng, h, w)
    return imgs, masks

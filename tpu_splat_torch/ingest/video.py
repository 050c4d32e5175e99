"""Video -> frames extraction (the port's copy of tpu_splat/ingest/video.py).

Replaces the reference's simple_video_to_images.py (uniform sampling of N frames
via np.linspace over the frame range, simple_video_to_images.py:30-130). Decode is
host-side (OpenCV); everything downstream is arrays.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

VIDEO_EXTENSIONS = (".mp4", ".mov", ".avi", ".mkv")
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")


def extract_frames(
    video_path: str,
    max_frames: int = 300,
    resize_max_dim: Optional[int] = None,
) -> np.ndarray:
    """Uniformly sample up to max_frames frames; returns (N, H, W, 3) float32 [0,1]."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if total <= 0:
        # fall back to reading everything
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        cap.release()
        if not frames:
            raise IOError(f"no frames decoded from {video_path}")
        idxs = np.linspace(0, len(frames) - 1, min(max_frames, len(frames))).astype(int)
        sel = [frames[i] for i in idxs]
    else:
        idxs = np.linspace(0, total - 1, min(max_frames, total)).astype(int)
        sel = []
        want = set(int(i) for i in idxs)
        pos = 0
        while True:
            ok = cap.grab()
            if not ok:
                break
            if pos in want:
                ok, frame = cap.retrieve()
                if ok:
                    sel.append(frame)
            pos += 1
        cap.release()
    out = []
    for frame in sel:
        rgb = frame[..., ::-1]  # BGR -> RGB
        if resize_max_dim:
            rgb = resize_to_max_dim(rgb, resize_max_dim)
        out.append(rgb.astype(np.float32) / 255.0)
    return np.stack(out)


def resize_to_max_dim(img: np.ndarray, max_dim: int) -> np.ndarray:
    """Downscale so max(H, W) <= max_dim (the reference's resize-to-4K rule,
    main.py:97-157, generalized)."""
    import cv2

    h, w = img.shape[:2]
    m = max(h, w)
    if m <= max_dim:
        return img
    scale = max_dim / m
    return cv2.resize(img, (int(round(w * scale)), int(round(h * scale))),
                      interpolation=cv2.INTER_AREA)


def load_images_from_dir(path: str, resize_max_dim: Optional[int] = None,
                         limit: Optional[int] = None) -> Tuple[np.ndarray, List[str]]:
    """Load all images in a directory (sorted). Returns (array, names).

    All images must share one size; differing sizes are resized to the first
    image's size (the reference forces a single camera / resolution via
    ImageReader.single_camera, main.py:950-985)."""
    import cv2

    names = sorted(
        f for f in os.listdir(path) if f.lower().endswith(IMAGE_EXTENSIONS)
    )
    if limit:
        names = names[:limit]
    imgs = []
    target = None
    for name in names:
        img = cv2.imread(os.path.join(path, name), cv2.IMREAD_UNCHANGED)
        if img is None:
            continue
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        if img.shape[2] == 4:
            img = composite_alpha(img)
        img = img[..., ::-1]  # BGR -> RGB
        if resize_max_dim:
            img = resize_to_max_dim(img, resize_max_dim)
        if target is None:
            target = img.shape[:2]
        elif img.shape[:2] != target:
            img = cv2.resize(img, (target[1], target[0]), interpolation=cv2.INTER_AREA)
        imgs.append(img.astype(np.float32) / 255.0)
    if not imgs:
        raise IOError(f"no images found in {path}")
    return np.stack(imgs), names[: len(imgs)]


def exif_focal_px(image_path: str, width: int) -> Optional[float]:
    """Focal length in pixels from EXIF metadata, or None.

    Prefers FocalLengthIn35mmFilm (fx = width * f35 / 36mm); falls back to
    FocalLength with a 7.0mm sensor-width guess (typical phone main camera) —
    a rough seed that the mapper's self-calibration then refines (the
    reference relies on COLMAP's EXIF reader + --refine_intrinsics the same
    way, main.py:1090-1113)."""
    try:
        from PIL import Image

        with Image.open(image_path) as im:
            exif = im.getexif()
            merged = dict(exif)
            try:  # focal tags live in the ExifIFD sub-directory
                merged.update(exif.get_ifd(0x8769))
            except Exception:
                pass
    except Exception:
        return None
    f35 = merged.get(0xA405)  # FocalLengthIn35mmFilm
    if f35:
        return float(width) * float(f35) / 36.0
    f_mm = merged.get(0x920A)  # FocalLength (rational or float)
    if f_mm:
        return float(width) * float(f_mm) / 7.0
    return None


def composite_alpha(img_bgra: np.ndarray, bg: int = 0) -> np.ndarray:
    """RGBA -> RGB compositing over a background (the reference converts RGBA
    inputs to RGB + mask, main.py:305)."""
    alpha = img_bgra[..., 3:4].astype(np.float32) / 255.0
    rgb = img_bgra[..., :3].astype(np.float32)
    out = rgb * alpha + bg * (1 - alpha)
    return out.astype(img_bgra.dtype)


# Pose-prior aux files recognized inside capture archives: NeRFCapture-style
# transforms(-in).json and COLMAP text/binary model files under sparse/
# (extract_poses_imgs.py:118 unpacks these alongside the images).
_AUX_NAMES = ("transforms.json", "transforms-in.json")
_COLMAP_NAMES = ("cameras.txt", "images.txt", "points3d.txt",
                 "cameras.bin", "images.bin", "points3d.bin")


def _is_depth_image(relpath: str) -> bool:
    """NeRFCapture zips carry per-frame depth maps; the reference separates
    them out of the image set (extract_poses_imgs.py separate_depth_images:87)."""
    low = relpath.lower()
    return "depth" in os.path.basename(low) or low.split("/")[0] == "depth"


def _is_mask_image(relpath: str) -> bool:
    """Captures using removeHumanSubject may ship per-frame mask images in a
    masks/ folder (remove_object_using_mask.py pairs them with frames); they
    must not enter the color-image set."""
    parts = relpath.lower().split("/")
    return "masks" in parts[:-1]


def extract_zip(zip_path: str, out_dir: str) -> List[str]:
    """Unpack a .zip capture; returns extracted color-image paths.

    Also extracts pose-prior aux files (transforms.json -> transforms-in.json,
    COLMAP sparse/ model files) preserving layout, and separates depth images
    into <out_dir>/depth/. Raises PipelineError 790 if no supported images are
    inside (main.py:1925-1943 parity)."""
    import zipfile

    from tpu_splat_torch.core.errors import PipelineError

    os.makedirs(out_dir, exist_ok=True)
    kept = []
    with zipfile.ZipFile(zip_path) as zf:
        for info in zf.infolist():
            if info.is_dir():
                continue
            base = os.path.basename(info.filename)
            if base.startswith("._"):
                continue
            low = base.lower()
            if low in _AUX_NAMES:
                # reference renames transforms.json -> transforms-in.json
                target = os.path.join(out_dir, "transforms-in.json")
            elif low in _COLMAP_NAMES:
                sub = os.path.dirname(info.filename)
                sub = sub[sub.find("sparse"):] if "sparse" in sub else "sparse/0"
                os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
                target = os.path.join(out_dir, sub, base)
            elif low.endswith(IMAGE_EXTENSIONS):
                if _is_depth_image(info.filename):
                    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
                    target = os.path.join(out_dir, "depth", base)
                elif _is_mask_image(info.filename):
                    os.makedirs(os.path.join(out_dir, "masks"), exist_ok=True)
                    target = os.path.join(out_dir, "masks", base)
                else:
                    target = os.path.join(out_dir, base)
                    kept.append(target)
            else:
                continue
            with zf.open(info) as src, open(target, "wb") as dst:
                dst.write(src.read())
    if not kept:
        raise PipelineError(790)
    return sorted(kept)

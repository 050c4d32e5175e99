"""COLMAP and Nerfstudio interchange formats (the port's copy of
tpu_splat/sfm/colmap_io.py; the files it writes are byte-equal).

Write/read COLMAP text AND binary models (cameras / images / points3D) and emit
Nerfstudio transforms.json — the Colmap-to-Nerfstudio conversion step of the
reference (colmap_to_nerfstudio_cam.py:32-73) plus the model-file handling of
process_pose_transforms.py (write_images_file :429, cameras SIMPLE_PINHOLE).
Also the SIMPLE_RADIAL -> SIMPLE_PINHOLE rewrite of update_camera_model.py.
Binary support matters for interchange: the real COLMAP writes .bin models by
default (the reference reads points3D.bin directly, main.py:407-417), so a
user bringing an existing COLMAP workspace must not need a text conversion.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_splat_torch.core.types import SfMScene, to_numpy

# COLMAP camera model ids <-> (name, param count) — src/colmap/sensor/models.h
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_CAMERA_MODEL_IDS = {name: (mid, np_) for mid, (name, np_) in
                     _CAMERA_MODELS.items()}


def _rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """3x3 -> COLMAP qvec (w, x, y, z)."""
    K = (
        np.array(
            [
                [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
                [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
                [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
                 R[0, 0] + R[1, 1] + R[2, 2]],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def write_colmap_model(
    scene: SfMScene,
    out_dir: str,
    image_names: Optional[List[str]] = None,
    camera_model: str = "PINHOLE",
) -> None:
    """Write sparse/0-style cameras.txt, images.txt, points3D.txt."""
    os.makedirs(out_dir, exist_ok=True)
    cams = scene.cameras
    n = len(cams)
    names = image_names or [f"frame_{i:05d}.png" for i in range(n)]

    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        fx = float(cams.fx[0])
        fy = float(cams.fy[0])
        cx = float(cams.cx[0])
        cy = float(cams.cy[0])
        if camera_model == "SIMPLE_PINHOLE":
            f.write(f"1 SIMPLE_PINHOLE {cams.width} {cams.height} {fx} {cx} {cy}\n")
        else:
            f.write(f"1 PINHOLE {cams.width} {cams.height} {fx} {fy} {cx} {cy}\n")

    w2c = np.asarray(cams.worldtocams)
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i in range(n):
            q = _rotmat_to_qvec(w2c[i, :3, :3])
            t = w2c[i, :3, 3]
            f.write(
                f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} 1 "
                f"{names[i]}\n\n"
            )

    pts = to_numpy(scene.points)
    cols = np.clip(to_numpy(scene.point_colors) * 255, 0, 255).astype(int)
    errs = to_numpy(scene.point_errors)
    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for i in range(pts.shape[0]):
            f.write(
                f"{i + 1} {pts[i, 0]} {pts[i, 1]} {pts[i, 2]} "
                f"{cols[i, 0]} {cols[i, 1]} {cols[i, 2]} {errs[i]}\n"
            )


def _read_cameras_bin(path: str) -> Dict:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = _CAMERA_MODELS.get(model_id, ("UNKNOWN", 0))
            params = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            cameras[cam_id] = {
                "model": name,
                "width": int(w),
                "height": int(h),
                "params": list(params),
            }
    return cameras


def _read_images_bin(path: str) -> Dict:
    images = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            data = struct.unpack("<idddddddi", f.read(64))
            image_id, qw, qx, qy, qz, tx, ty, tz, cam_id = data
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts2d,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n_pts2d, os.SEEK_CUR)  # (x, y double, point3D_id i64)
            images[name.decode("utf-8")] = {
                "qvec": np.array([qw, qx, qy, qz]),
                "tvec": np.array([tx, ty, tz]),
                "camera_id": int(cam_id),
            }
    return images


def _read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    pts, cols = [], []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            data = struct.unpack("<QdddBBBd", f.read(43))
            pts.append(data[1:4])
            cols.append(data[4:7])
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.seek(8 * track_len, os.SEEK_CUR)  # (image_id, point2D_idx) i32s
    return np.array(pts), np.array(cols)


def read_colmap_model(model_dir: str) -> Tuple[Dict, Dict, np.ndarray, np.ndarray]:
    """Read a COLMAP model, text or binary (auto-detected; text preferred when
    both exist). Returns (cameras, images, points, colors).

    cameras: id -> dict(model, width, height, params);
    images: name -> dict(qvec, tvec, camera_id)."""
    if not os.path.exists(os.path.join(model_dir, "cameras.txt")) and \
            os.path.exists(os.path.join(model_dir, "cameras.bin")):
        cameras = _read_cameras_bin(os.path.join(model_dir, "cameras.bin"))
        images = _read_images_bin(os.path.join(model_dir, "images.bin"))
        p3d = os.path.join(model_dir, "points3D.bin")
        if os.path.exists(p3d):
            pts, cols = _read_points3d_bin(p3d)
        else:
            pts, cols = np.zeros((0, 3)), np.zeros((0, 3))
        return cameras, images, pts, cols
    cameras = {}
    with open(os.path.join(model_dir, "cameras.txt")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cameras[int(parts[0])] = {
                "model": parts[1],
                "width": int(parts[2]),
                "height": int(parts[3]),
                "params": [float(p) for p in parts[4:]],
            }
    images = {}
    with open(os.path.join(model_dir, "images.txt")) as f:
        lines = [l for l in f if not l.startswith("#")]
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line:
            continue
        parts = line.split()
        images[parts[9]] = {
            "qvec": np.array([float(p) for p in parts[1:5]]),
            "tvec": np.array([float(p) for p in parts[5:8]]),
            "camera_id": int(parts[8]),
        }
        if i < len(lines):
            i += 1  # skip the POINTS2D line
    pts, cols = [], []
    p3d = os.path.join(model_dir, "points3D.txt")
    if os.path.exists(p3d):
        with open(p3d) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                pts.append([float(p) for p in parts[1:4]])
                cols.append([int(p) for p in parts[4:7]])
    return cameras, images, np.array(pts), np.array(cols)


def write_colmap_model_binary(
    scene: SfMScene,
    out_dir: str,
    image_names: Optional[List[str]] = None,
    camera_model: str = "PINHOLE",
) -> None:
    """Write sparse/0-style cameras.bin / images.bin / points3D.bin (the real
    COLMAP's default on-disk format, so downstream tools that only speak
    binary can consume our reconstructions directly)."""
    os.makedirs(out_dir, exist_ok=True)
    cams = scene.cameras
    n = len(cams)
    names = image_names or [f"frame_{i:05d}.png" for i in range(n)]
    fx, fy = float(cams.fx[0]), float(cams.fy[0])
    cx, cy = float(cams.cx[0]), float(cams.cy[0])

    with open(os.path.join(out_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        if camera_model == "SIMPLE_PINHOLE":
            f.write(struct.pack("<iiQQ", 1, 0, cams.width, cams.height))
            f.write(struct.pack("<3d", fx, cx, cy))
        else:
            f.write(struct.pack("<iiQQ", 1, 1, cams.width, cams.height))
            f.write(struct.pack("<4d", fx, fy, cx, cy))

    w2c = np.asarray(cams.worldtocams)
    with open(os.path.join(out_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            q = _rotmat_to_qvec(w2c[i, :3, :3])
            t = w2c[i, :3, 3]
            f.write(struct.pack("<idddddddi", i + 1, q[0], q[1], q[2], q[3],
                                t[0], t[1], t[2], 1))
            f.write(names[i].encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))  # no per-image 2D points recorded

    pts = to_numpy(scene.points)
    cols = np.clip(to_numpy(scene.point_colors) * 255, 0, 255).astype(int)
    errs = to_numpy(scene.point_errors)
    with open(os.path.join(out_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", pts.shape[0]))
        for i in range(pts.shape[0]):
            f.write(struct.pack("<QdddBBBd", i + 1, pts[i, 0], pts[i, 1],
                                pts[i, 2], cols[i, 0], cols[i, 1], cols[i, 2],
                                float(errs[i])))
            f.write(struct.pack("<Q", 0))  # empty track


def count_points3d(model_dir: str) -> int:
    """Sparse-point count for the quality gate (main.py read_colmap_points3d_count
    reads the points3D.bin header the same way)."""
    path = os.path.join(model_dir, "points3D.txt")
    if os.path.exists(path):
        with open(path) as f:
            return sum(1 for l in f if l.strip() and not l.startswith("#"))
    binp = os.path.join(model_dir, "points3D.bin")
    if os.path.exists(binp):
        with open(binp, "rb") as f:
            header = f.read(8)
        return int(struct.unpack("<Q", header)[0]) if len(header) == 8 else 0
    return 0


def update_camera_model_to_pinhole(cameras_txt: str) -> None:
    """Rewrite SIMPLE_RADIAL -> SIMPLE_PINHOLE after undistortion
    (update_camera_model.py:31-115 parity: drops the k1 parameter)."""
    with open(cameras_txt) as f:
        lines = f.readlines()
    out = []
    for line in lines:
        if line.startswith("#") or not line.strip():
            out.append(line)
            continue
        parts = line.split()
        if parts[1] == "SIMPLE_RADIAL":
            parts[1] = "SIMPLE_PINHOLE"
            parts = parts[:7]  # id model w h f cx cy (drop k1)
            out.append(" ".join(parts) + "\n")
        else:
            out.append(line)
    with open(cameras_txt, "w") as f:
        f.writelines(out)


def write_transforms_json(
    scene: SfMScene,
    out_path: str,
    image_names: Optional[List[str]] = None,
    ply_path: Optional[str] = None,
) -> dict:
    """Emit Nerfstudio transforms.json (colmap_to_nerfstudio_cam.py analog).

    Nerfstudio convention: camera-to-world in OpenGL axes (+x right, +y up,
    -z forward); conversion from OpenCV flips the y and z camera axes."""
    cams = scene.cameras
    n = len(cams)
    names = image_names or [f"frame_{i:05d}.png" for i in range(n)]
    c2w = to_numpy(cams.camtoworlds)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    frames = []
    for i in range(n):
        m = c2w[i] @ flip
        frames.append({
            "file_path": f"images/{names[i]}",
            "transform_matrix": m.tolist(),
        })
    data = {
        "fl_x": float(cams.fx[0]),
        "fl_y": float(cams.fy[0]),
        "cx": float(cams.cx[0]),
        "cy": float(cams.cy[0]),
        "w": cams.width,
        "h": cams.height,
        "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0,
        "camera_model": "OPENCV",
        "frames": frames,
    }
    if ply_path:
        data["ply_file_path"] = ply_path
    with open(out_path, "w") as f:
        json.dump(data, f, indent=2)
    return data

"""COLMAP SQLite database (database.db) interchange (the port's copy of
tpu_splat/sfm/colmap_db.py).

The reference pipeline works directly against COLMAP's feature/match database:
the pose-prior path inserts rows into its `pose_priors` table
(process_pose_transforms.py:487 `update_colmap_db_with_pose_priors`) and every
COLMAP engine invocation (feature_extractor / matchers / mapper,
main.py:950-1154) reads and writes it. Owning the format lets a user of the
reference bring an existing database.db here (skip extraction/matching), and
inspect THIS framework's features/matches with stock COLMAP tooling.

Schema follows COLMAP's public definition (camera model ids, blob layouts,
pair_id = image_id1 * 2147483647 + image_id2 with id1 < id2; match columns
swap when the stored order is reversed). Keypoints are written as the 6-column
affine form a = scale * R(orientation); descriptors quantize the L2-normalized
float descriptors to COLMAP's uint8 convention (x512, clipped to 255).
"""

from __future__ import annotations

import sqlite3
from typing import Dict, List, Optional, Tuple

import numpy as np

MAX_IMAGE_ID = 2147483647

# COLMAP camera model ids (subset used here)
SIMPLE_PINHOLE = 0  # f, cx, cy
PINHOLE = 1  # fx, fy, cx, cy
SIMPLE_RADIAL = 2  # f, cx, cy, k

# two_view_geometries.config values
CONFIG_CALIBRATED = 2

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
CREATE TABLE IF NOT EXISTS pose_priors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    position BLOB, coordinate_system INTEGER NOT NULL,
    position_covariance BLOB);
"""


def pair_id_from_images(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def images_from_pair_id(pair_id: int) -> Tuple[int, int]:
    return pair_id // MAX_IMAGE_ID, pair_id % MAX_IMAGE_ID


def _affine_from_scale_orient(scale: np.ndarray, orient: np.ndarray):
    c, s = np.cos(orient), np.sin(orient)
    return (scale * c, -scale * s, scale * s, scale * c)


def write_database(
    path: str,
    width: int,
    height: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    image_names: List[str],
    keypoints: List[np.ndarray],
    descriptors: Optional[List[np.ndarray]] = None,
    scales: Optional[List[np.ndarray]] = None,
    orientations: Optional[List[np.ndarray]] = None,
    matches: Optional[Dict[Tuple[int, int], np.ndarray]] = None,
    verified: Optional[Dict[Tuple[int, int], np.ndarray]] = None,
    k1: float = 0.0,
    pose_priors: Optional[np.ndarray] = None,
) -> None:
    """Write a COLMAP database.db.

    image_names/keypoints/... are indexed by OUR 0-based image index; COLMAP
    image_ids are that index + 1. `matches` holds raw (idx_a, idx_b) match
    arrays per (a, b) pair with a < b; `verified` holds the geometrically
    verified subsets (written to two_view_geometries, the table COLMAP's
    mapper actually consumes). `pose_priors` is an optional (N, 3) array of
    prior positions (reference process_pose_transforms.py:487)."""
    conn = sqlite3.connect(path)
    try:
        conn.executescript(_SCHEMA)
        if abs(k1) > 0.0:
            model, params = SIMPLE_RADIAL, [fx, cx, cy, k1]
        elif abs(fx - fy) < 1e-6:
            model, params = SIMPLE_PINHOLE, [fx, cx, cy]
        else:
            model, params = PINHOLE, [fx, fy, cx, cy]
        conn.execute(
            "INSERT OR REPLACE INTO cameras VALUES (1, ?, ?, ?, ?, 1)",
            (model, int(width), int(height),
             np.asarray(params, np.float64).tobytes()),
        )
        for i, name in enumerate(image_names):
            conn.execute(
                "INSERT OR REPLACE INTO images VALUES "
                "(?, ?, 1, NULL, NULL, NULL, NULL, NULL, NULL, NULL)",
                (i + 1, name),
            )
        for i, kp in enumerate(keypoints):
            kp = np.asarray(kp, np.float32)
            k = len(kp)
            if scales is not None and orientations is not None:
                a11, a12, a21, a22 = _affine_from_scale_orient(
                    np.asarray(scales[i], np.float32),
                    np.asarray(orientations[i], np.float32))
                rows6 = np.stack(
                    [kp[:, 0], kp[:, 1], a11, a12, a21, a22], axis=1)
            else:
                one = np.ones(k, np.float32)
                zero = np.zeros(k, np.float32)
                rows6 = np.stack(
                    [kp[:, 0], kp[:, 1], one, zero, zero, one], axis=1)
            conn.execute(
                "INSERT OR REPLACE INTO keypoints VALUES (?, ?, 6, ?)",
                (i + 1, k, rows6.astype(np.float32).tobytes()),
            )
            if descriptors is not None:
                d = np.asarray(descriptors[i], np.float32)
                d_u8 = np.clip(d * 512.0, 0, 255).astype(np.uint8)
                conn.execute(
                    "INSERT OR REPLACE INTO descriptors VALUES (?, ?, 128, ?)",
                    (i + 1, len(d_u8), d_u8.tobytes()),
                )
        for table, source in (("matches", matches),
                              ("two_view_geometries", verified)):
            if source is None:
                continue
            for (a, b), idx in source.items():
                idx = np.asarray(idx, np.uint32).reshape(-1, 2)
                pid = pair_id_from_images(a + 1, b + 1)
                if a + 1 > b + 1:
                    idx = idx[:, ::-1]
                if table == "matches":
                    conn.execute(
                        "INSERT OR REPLACE INTO matches VALUES (?, ?, 2, ?)",
                        (pid, len(idx), np.ascontiguousarray(idx).tobytes()),
                    )
                else:
                    conn.execute(
                        "INSERT OR REPLACE INTO two_view_geometries VALUES "
                        "(?, ?, 2, ?, ?, NULL, NULL, NULL, NULL, NULL)",
                        (pid, len(idx), np.ascontiguousarray(idx).tobytes(),
                         CONFIG_CALIBRATED),
                    )
        if pose_priors is not None:
            pp = np.asarray(pose_priors, np.float64)
            cov = np.full((3, 3), np.nan)
            for i in range(len(image_names)):
                conn.execute(
                    "INSERT OR REPLACE INTO pose_priors VALUES (?, ?, 1, ?)",
                    (i + 1, pp[i].tobytes(), cov.tobytes()),
                )
        conn.commit()
    finally:
        conn.close()


def read_database(path: str) -> dict:
    """Read a COLMAP database.db into plain numpy structures.

    Returns {cameras: {id: {model, width, height, params}},
             images: {id: name}, keypoints: {id: (K, cols) f32},
             descriptors: {id: (K, 128) u8},
             matches: {(a, b): (M, 2) u32 0-based our-index},
             two_view: {(a, b): (M, 2) u32}, pose_priors: {id: (3,) f64}}.
    Image pair keys are 0-based (COLMAP image_id - 1), a < b."""
    conn = sqlite3.connect(path)
    out = {"cameras": {}, "images": {}, "keypoints": {}, "descriptors": {},
           "matches": {}, "two_view": {}, "pose_priors": {}}
    try:
        for cid, model, w, h, params in conn.execute(
                "SELECT camera_id, model, width, height, params FROM cameras"):
            out["cameras"][cid] = {
                "model": model, "width": w, "height": h,
                "params": np.frombuffer(params, np.float64).copy(),
            }
        for iid, name in conn.execute("SELECT image_id, name FROM images"):
            out["images"][iid] = name
        for iid, rows, cols, data in conn.execute(
                "SELECT image_id, rows, cols, data FROM keypoints"):
            arr = (np.frombuffer(data, np.float32).reshape(rows, cols).copy()
                   if rows else np.zeros((0, cols), np.float32))
            out["keypoints"][iid] = arr
        try:
            for iid, rows, cols, data in conn.execute(
                    "SELECT image_id, rows, cols, data FROM descriptors"):
                arr = (np.frombuffer(data, np.uint8).reshape(rows, cols).copy()
                       if rows else np.zeros((0, cols), np.uint8))
                out["descriptors"][iid] = arr
        except sqlite3.OperationalError:
            pass
        for table, key in (("matches", "matches"),
                           ("two_view_geometries", "two_view")):
            try:
                for pid, rows, cols, data in conn.execute(
                        f"SELECT pair_id, rows, cols, data FROM {table}"):
                    if not rows or data is None:
                        continue
                    id1, id2 = images_from_pair_id(pid)
                    idx = np.frombuffer(data, np.uint32).reshape(rows, 2).copy()
                    out[key][(id1 - 1, id2 - 1)] = idx
            except sqlite3.OperationalError:
                pass
        try:
            for iid, pos, cs, cov in conn.execute(
                    "SELECT image_id, position, coordinate_system, "
                    "position_covariance FROM pose_priors"):
                if pos is not None:
                    out["pose_priors"][iid] = np.frombuffer(
                        pos, np.float64).copy()
        except sqlite3.OperationalError:
            pass
    finally:
        conn.close()
    return out

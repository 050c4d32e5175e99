"""The port's undistortion, COLMAP model and database I/O
(tpu_splat_torch/sfm/{undistort,colmap_io,colmap_db}.py and the mapper's
database hand-off) against the JAX package's, on the same seeded inputs:
images within 1e-5, points within 1e-4 px, every written file byte-equal, and
database contents equal."""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.core import types as jtypes
from tpu_splat.sfm import colmap_db as jdb
from tpu_splat.sfm import colmap_io as jio
from tpu_splat.sfm import mapper as jmapper
from tpu_splat.sfm import undistort as jund
from tpu_splat.sfm.features import FeatureConfig as JFeatureConfig
from tpu_splat_torch.core import types as ttypes
from tpu_splat_torch.sfm import colmap_db as tdb
from tpu_splat_torch.sfm import colmap_io as tio
from tpu_splat_torch.sfm import mapper as tmapper
from tpu_splat_torch.sfm import undistort as tund
from tpu_splat_torch.sfm.features import Features

torch.set_num_threads(1)

W, H = 64, 48
INTRIN = (52.0, 50.5, 31.7, 24.2)
DIST = dict(k1=-0.18, k2=0.04, p1=0.003, p2=-0.002)


def test_undistort_image_batch_and_points_match_reference():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    want = np.asarray(jund.undistort_image(jnp.asarray(img), *INTRIN, **DIST))
    got = tund.undistort_image(img, *INTRIN, **DIST, device="cpu")
    assert isinstance(got, torch.Tensor) and got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    batch = np.stack([img, img[::-1].copy()])
    want_b = jund.undistort_batch(batch, *INTRIN, **DIST)
    got_b = tund.undistort_batch(batch, *INTRIN, **DIST, device="cpu")
    assert got_b.dtype == np.float32 and got_b.shape == batch.shape
    np.testing.assert_allclose(got_b, want_b, atol=1e-5, rtol=0)
    pts = np.stack([rng.uniform(0, W, 40), rng.uniform(0, H, 40)], 1)
    np.testing.assert_allclose(tund.undistort_points(pts, *INTRIN, **DIST),
                               jund.undistort_points(pts, *INTRIN, **DIST), atol=1e-4, rtol=0)


def _rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def seeded_scenes(n_cams=3, n_pts=12):
    """One SfMScene in each package, from the same float32 numpy arrays."""
    rng = np.random.default_rng(4)
    c2w = np.tile(np.eye(4), (n_cams, 1, 1))
    for i in range(n_cams):
        c2w[i, :3, :3] = _rotation(rng)
        c2w[i, :3, 3] = rng.normal(0, 2, 3)
    a = dict(camtoworlds=c2w.astype(np.float32),
             fx=np.full(n_cams, INTRIN[0], np.float32), fy=np.full(n_cams, INTRIN[1], np.float32),
             cx=np.full(n_cams, INTRIN[2], np.float32), cy=np.full(n_cams, INTRIN[3], np.float32),
             distortion=np.zeros((n_cams, 4), np.float32))
    s = dict(points=rng.normal(0, 3, (n_pts, 3)).astype(np.float32),
             point_colors=rng.uniform(0, 1, (n_pts, 3)).astype(np.float32),
             point_errors=rng.uniform(0, 2, n_pts).astype(np.float32),
             track_counts=np.full(n_pts, 3, np.int32), registered=np.ones(n_cams, bool))
    ref = jtypes.SfMScene(cameras=jtypes.Cameras(**{k: jnp.asarray(v) for k, v in a.items()},
                                                 width=W, height=H),
                          **{k: jnp.asarray(v) for k, v in s.items()})
    port = ttypes.SfMScene(cameras=ttypes.Cameras(**a, width=W, height=H), **s)
    return ref, port


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("camera_model", ["PINHOLE", "SIMPLE_PINHOLE"])
def test_model_files_and_transforms_json_are_byte_equal(tmp_path, camera_model):
    ref, port = seeded_scenes()
    names = [f"img_{i}.png" for i in range(3)]
    for pkg, scene, io in (("ref", ref, jio), ("port", port, tio)):
        d = tmp_path / pkg
        io.write_colmap_model(scene, str(d), image_names=names, camera_model=camera_model)
        io.write_colmap_model_binary(scene, str(d), image_names=names,
                                     camera_model=camera_model)
        io.write_transforms_json(scene, str(d / "transforms.json"), image_names=names,
                                 ply_path="splat.ply")
    want, got = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(got) == ["cameras.bin", "cameras.txt", "images.bin", "images.txt",
                           "points3D.bin", "points3D.txt", "transforms.json"]
    for name in want:
        assert got[name] == want[name], name


def test_readers_round_trip_and_pinhole_rewrite_is_byte_equal(tmp_path):
    ref, port = seeded_scenes()
    names = [f"img_{i}.png" for i in range(3)]
    txt, binary = tmp_path / "txt", tmp_path / "bin"
    tio.write_colmap_model(port, str(txt), image_names=names)
    tio.write_colmap_model_binary(port, str(binary), image_names=names)
    for d in (txt, binary):
        cams_t, imgs_t, pts_t, cols_t = tio.read_colmap_model(str(d))
        cams_j, imgs_j, pts_j, cols_j = jio.read_colmap_model(str(d))
        assert cams_t == cams_j and list(imgs_t) == names == list(imgs_j)
        for name in names:
            for key in ("qvec", "tvec"):
                np.testing.assert_array_equal(imgs_t[name][key], imgs_j[name][key])
            # the pose reads back: qvec/tvec are world-to-camera
            R = tio.qvec_to_rotmat(imgs_t[name]["qvec"])
            np.testing.assert_array_equal(R, jio.qvec_to_rotmat(imgs_t[name]["qvec"]))
            w2c = port.cameras.worldtocams[names.index(name)]
            np.testing.assert_allclose(R, w2c[:3, :3], atol=1e-5)
            np.testing.assert_allclose(imgs_t[name]["tvec"], w2c[:3, 3], atol=1e-5)
        np.testing.assert_array_equal(pts_t, pts_j)
        np.testing.assert_array_equal(cols_t, cols_j)
        np.testing.assert_allclose(pts_t, port.points, atol=1e-6)
        assert tio.count_points3d(str(d)) == jio.count_points3d(str(d)) == port.num_points
    radial = ("# Camera list\n1 SIMPLE_RADIAL 64 48 52.0 31.7 24.2 -0.18\n"
              "2 PINHOLE 64 48 52.0 50.5 31.7 24.2\n")
    for pkg, io in (("ref", jio), ("port", tio)):
        path = tmp_path / f"cameras_{pkg}.txt"
        path.write_text(radial)
        io.update_camera_model_to_pinhole(str(path))
    assert (tmp_path / "cameras_port.txt").read_bytes() == \
        (tmp_path / "cameras_ref.txt").read_bytes()
    assert "1 SIMPLE_PINHOLE 64 48 52.0 31.7 24.2\n" in (tmp_path / "cameras_port.txt").read_text()


def _db_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].keys() == b[key].keys(), key
        for k in a[key]:
            x, y = a[key][k], b[key][k]
            if isinstance(x, dict):
                assert x.keys() == y.keys()
                for f in x:
                    np.testing.assert_array_equal(x[f], y[f])
            else:
                np.testing.assert_array_equal(x, y)


def _read_both(path):
    got = tdb.read_database(path)
    _db_equal(got, jdb.read_database(path))
    return got


@pytest.mark.parametrize("k1", [0.0, -0.05])
def test_write_read_database_contents_match_reference(tmp_path, k1):
    rng = np.random.default_rng(3)
    n = 3
    names = [f"frame_{i:04d}.png" for i in range(n)]
    kps = [rng.uniform(0, 100, (8 + i, 2)).astype(np.float32) for i in range(n)]
    descs = [rng.uniform(0, 0.3, (8 + i, 128)).astype(np.float32) for i in range(n)]
    scales = [rng.uniform(1, 3, 8 + i).astype(np.float32) for i in range(n)]
    orients = [rng.uniform(-3, 3, 8 + i).astype(np.float32) for i in range(n)]
    matches = {(0, 1): np.array([[0, 1], [2, 3]], np.uint32),
               (1, 2): np.array([[4, 5]], np.uint32)}
    priors = rng.normal(0, 1, (n, 3))
    dbs = {}
    for pkg, db in (("ref", jdb), ("port", tdb)):
        path = str(tmp_path / f"{pkg}.db")
        db.write_database(path, 64, 48, 50.0, 50.0, 32.0, 24.0, names, keypoints=kps,
                          descriptors=descs, scales=scales, orientations=orients,
                          matches=matches, verified=matches, k1=k1, pose_priors=priors)
        dbs[pkg] = _read_both(path)
    _db_equal(dbs["port"], dbs["ref"])
    assert dbs["port"]["cameras"][1]["model"] == (2 if k1 else 0)
    assert tdb.pair_id_from_images(9, 4) == jdb.pair_id_from_images(4, 9)
    assert tdb.images_from_pair_id(tdb.pair_id_from_images(4, 9)) == (4, 9)


def _injected_features(k=16, n=2):
    rng = np.random.default_rng(5)
    return [dict(xy=rng.uniform(0, 32, (k, 2)).astype(np.float32),
                 scale=rng.uniform(1, 2, k).astype(np.float32),
                 orientation=rng.uniform(-3, 3, k).astype(np.float32),
                 response=np.ones(k, np.float32),
                 descriptor=rng.uniform(0, 0.2, (k, 128)).astype(np.float32),
                 valid=np.ones(k, bool)) for _ in range(n)]


def test_export_database_and_mapper_from_database_match_reference(tmp_path):
    """Mappers holding the same injected features and verified matches export
    databases with equal contents, and seeding a mapper from one database
    gives equal features (the port's also as stacked tensors on its device),
    pair sets, intrinsics and k1."""
    imgs = np.random.default_rng(6).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    feats = _injected_features()
    matches = {(0, 1): np.array([[1, 2], [5, 9], [3, 3]] + [[i, i] for i in range(4, 24)],
                                np.uint32) % 16}
    jm = jmapper.IncrementalMapper(imgs, jmapper.MapperConfig(feature=JFeatureConfig()),
                                   fx=30.0, fy=30.0, cx=16.0, cy=16.0)
    jm.feats = [SimpleNamespace(**{k: jnp.asarray(v) for k, v in f.items()}) for f in feats]
    tm = tmapper.IncrementalMapper(imgs, tmapper.MapperConfig(), fx=30.0, fy=30.0, cx=16.0,
                                   cy=16.0, device="cpu")
    tm.feats = [Features(**f) for f in feats]
    for m in (jm, tm):
        m.pair_matches = dict(matches)
        m.k1 = -0.05
    jm.export_colmap_database(str(tmp_path / "ref.db"))
    tm.export_colmap_database(str(tmp_path / "port.db"))
    port_db = _read_both(str(tmp_path / "port.db"))
    _db_equal(port_db, _read_both(str(tmp_path / "ref.db")))
    assert port_db["cameras"][1]["model"] == 2 and len(port_db["images"]) == 2

    path = str(tmp_path / "port.db")
    jm2 = jmapper._mapper_from_database(imgs, jmapper.MapperConfig(), path, None, None, None,
                                        None, None)
    tm2 = tmapper._mapper_from_database(imgs, tmapper.MapperConfig(), path, None, None, None,
                                        None, None, device="cpu")
    assert (tm2.fx, tm2.fy, tm2.cx, tm2.cy, tm2.k1) == (jm2.fx, jm2.fy, jm2.cx, jm2.cy, jm2.k1)
    assert tm2.k1 == pytest.approx(-0.05)
    for fj, ft in zip(jm2.feats, tm2.feats):
        for name in Features._fields:
            np.testing.assert_array_equal(getattr(ft, name), np.asarray(getattr(fj, name)))
    assert torch.equal(tm2._desc_d, torch.from_numpy(np.stack([f.descriptor for f in tm2.feats])))
    assert tm2._valid_d.dtype == torch.bool and tm2._valid_d.all()
    assert tm2.pair_matches.keys() == jm2.pair_matches.keys() == {(0, 1)}
    np.testing.assert_array_equal(tm2.pair_matches[(0, 1)], jm2.pair_matches[(0, 1)])
    assert tm2.pair_inliers == jm2.pair_inliers

    # a database whose images hold different keypoint counts, as COLMAP's do
    ragged = str(tmp_path / "ragged.db")
    tdb.write_database(ragged, 32, 32, 30.0, 30.0, 16.0, 16.0, ["a.png", "b.png"],
                       keypoints=[feats[0]["xy"], feats[1]["xy"][:9]],
                       descriptors=[feats[0]["descriptor"], feats[1]["descriptor"][:9]])
    tm3 = tmapper._mapper_from_database(imgs, tmapper.MapperConfig(), ragged, None, None, None,
                                        None, None, device="cpu")
    assert [len(f.xy) for f in tm3.feats] == [16, 9]
    assert tm3._desc_d.shape == (2, 16, 128) and tm3._valid_d.sum(1).tolist() == [16, 9]
    np.testing.assert_array_equal(tm3._desc_d[1, :9].numpy(), tm3.feats[1].descriptor)

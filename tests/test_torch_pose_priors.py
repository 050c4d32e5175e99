"""The port's pose priors (tpu_splat_torch/sfm/pose_priors.py) against the
JAX package's, on the CPU: the pose conversions of every convention in both
directions, the normalisation and the transforms.json parser exactly, and
sfm_with_pose_priors on a synthetic mapper state.

For the latter, both mappers' extract_all/match_all are replaced by one that
installs the same noise-free keypoints (every point of a seeded cloud
projected into every view of an arc) and matches (every pair, every point),
so no feature extractor compiles; build_tracks, triangulation, bundle
adjustment and the filters run for real. The prior poses are the true ones
moved by a seeded 0.5-degree and 1% perturbation, so BA has work to do;
points and BA-refined poses agree within 1e-4."""

import json

import numpy as np
import pytest
import torch

from tpu_splat.sfm import features as jfeatures
from tpu_splat.sfm import mapper as jmapper
from tpu_splat.sfm import pose_priors as jpp
from tpu_splat_torch.sfm import features as tfeatures
from tpu_splat_torch.sfm import mapper as tmapper
from tpu_splat_torch.sfm import pose_priors as tpp

torch.set_num_threads(1)

W, H, FX = 320, 240, 300.0


def _rot(axis_angle):
    th = np.linalg.norm(axis_angle)
    if th < 1e-15:
        return np.eye(3)
    k = axis_angle / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def synthetic_views(n=8, n_pts=120, seed=0):
    """(w2c (n, 4, 4) f64, per-view pixel keypoints (n, P, 2) f32) of a
    seeded cloud seen from an arc of cameras looking at its centre; every
    point projects inside every view."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n_pts, 3)) * [1.5, 1.0, 1.0] + [0, 0, 6.0]
    w2c = np.tile(np.eye(4), (n, 1, 1))
    for i, a in enumerate(np.linspace(-0.35, 0.35, n)):
        eye = np.array([6.0 * np.sin(a), 0.3 * np.cos(3 * a), 6.0 - 6.0 * np.cos(a)])
        z = np.array([0, 0, 6.0]) - eye
        z /= np.linalg.norm(z)
        x = np.cross([0, 1.0, 0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        w2c[i, :3, :3], w2c[i, :3, 3] = R, -R @ eye
    pc = np.einsum("nij,pj->npi", w2c[:, :3, :3], pts) + w2c[:, None, :3, 3]
    uv = FX * pc[..., :2] / pc[..., 2:] + [W / 2, H / 2]
    assert (uv > 5).all() and (uv[..., 0] < W - 5).all() and (uv[..., 1] < H - 5).all()
    return w2c, uv.astype(np.float32)


def install_front_end(monkeypatch, uv):
    """Replace both mappers' extract_all and match_all: every view's features
    are the points' projections, every pair matches every point."""
    n, p = uv.shape[:2]

    def make(features_mod):
        def extract_all(self):
            self.feats = [features_mod.Features(
                xy=uv[i], scale=np.ones(p, np.float32), orientation=np.zeros(p, np.float32),
                response=np.ones(p, np.float32), descriptor=np.zeros((p, 128), np.float32),
                valid=np.ones(p, bool)) for i in range(n)]
            self._xy_all = None

        def match_all(self):
            idx = np.stack([np.arange(p), np.arange(p)], 1)
            self.pair_matches = {(a, b): idx.copy() for a in range(n) for b in range(a + 1, n)}
            self.pair_inliers = {k: p for k in self.pair_matches}
        return extract_all, match_all

    for mod, feats in ((jmapper, jfeatures), (tmapper, tfeatures)):
        extract_all, match_all = make(feats)
        monkeypatch.setattr(mod.IncrementalMapper, "extract_all", extract_all)
        monkeypatch.setattr(mod.IncrementalMapper, "match_all", match_all)


@pytest.mark.parametrize("source", sorted(tpp.CONVENTIONS))
@pytest.mark.parametrize("w2c", [False, True], ids=["c2w", "w2c"])
def test_convert_pose_matches_reference(source, w2c):
    rng = np.random.default_rng(len(source))
    m = np.eye(4)
    m[:3, :3] = _rot(rng.normal(size=3))
    m[:3, 3] = rng.normal(size=3)
    np.testing.assert_array_equal(tpp.convert_pose(m, source.upper(), w2c),
                                  jpp.convert_pose(m, source.upper(), w2c))
    np.testing.assert_array_equal(tpp.CONVENTIONS[source], jpp.CONVENTIONS[source])
    with pytest.raises(ValueError):
        tpp.convert_pose(m, "nope", w2c)


def test_normalize_and_transforms_json_match_reference(tmp_path):
    rng = np.random.default_rng(1)
    c2ws = np.tile(np.eye(4), (5, 1, 1))
    c2ws[:, :3, 3] = rng.normal(0, 3, (5, 3))
    for got, want in zip(tpp.normalize_poses(c2ws), jpp.normalize_poses(c2ws)):
        np.testing.assert_array_equal(got, want)
    frames = [{"file_path": f"images/f{i}.png", "transform_matrix": c2ws[i].tolist()}
              for i in range(5)]
    frames.append({"transform_matrix": np.eye(4).tolist()})  # no file_path
    path = tmp_path / "transforms-in.json"
    path.write_text(json.dumps({"fl_x": 500.0, "cy": 240.5, "w": 640, "frames": frames}))
    for kw in ({}, {"source": "opengl", "is_world_to_cam": False}):
        got, want = tpp.load_transforms_json(str(path), **kw), jpp.load_transforms_json(
            str(path), **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] and got[2][-1] == "00005.png"


def test_sfm_with_pose_priors_matches_reference(monkeypatch):
    w2c, uv = synthetic_views()
    install_front_end(monkeypatch, uv)
    rng = np.random.default_rng(5)
    prior = np.linalg.inv(w2c)
    for i in range(1, len(prior)):  # priors off by 0.5 degrees and 1%
        prior[i, :3, :3] = _rot(rng.normal(0, np.radians(0.5) / np.sqrt(3), 3)) @ prior[i, :3, :3]
        prior[i, :3, 3] += rng.normal(0, 0.01 * 6.0 / np.sqrt(3), 3)
    images = np.zeros((len(w2c), H, W, 3), np.float32)
    args = (images, prior, FX, FX, W / 2, H / 2)
    want = jpp.sfm_with_pose_priors(*args)
    logs = []
    got = tpp.sfm_with_pose_priors(*args, log_fn=logs.append, device="cpu")
    assert any(s.startswith("BA:") for s in logs)
    assert got.registered.all() and np.asarray(want.registered).all()
    assert got.num_points == want.num_points == uv.shape[1]
    np.testing.assert_allclose(got.points, np.asarray(want.points), atol=1e-4, rtol=0)
    c2w_got, c2w_want = got.cameras.camtoworlds, np.asarray(want.cameras.camtoworlds)
    np.testing.assert_allclose(c2w_got, c2w_want, atol=1e-4, rtol=0)
    assert np.abs(c2w_got - prior).max() > 1e-3  # BA moved the poses
    np.testing.assert_array_equal(got.track_counts, np.asarray(want.track_counts))

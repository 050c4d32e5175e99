"""The port's global SfM (tpu_splat_torch/sfm/global_mapper.py) against the
JAX package's, on the CPU.

The averaging functions get tests/test_global_sfm.py's seeded inputs (a
chain of 12-16 rotations with and without noise, a 16-camera ring of
directions, the closed 20-camera ring with rays and its partial-visibility
variant) and agree within 1e-9 in f64. GlobalMapper.reconstruct runs on
test_torch_pose_priors' synthetic state (5 views, noise-free keypoints,
every pair matching every point, so every pair has the same count: the
result does not depend on the RANSAC draws, and the reference's
essential_ransac compiles once); poses agree within 1e-4 and the registered
masks are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_global_sfm as ref_tests
from test_global_sfm import chain_pairs, ring
from test_torch_pose_priors import FX, H, W, install_front_end, synthetic_views
from tpu_splat.sfm import global_mapper as jgm
from tpu_splat.sfm.geometry import exp_so3
from tpu_splat.sfm.mapper import MapperConfig as JMapperConfig
from tpu_splat_torch.sfm import global_mapper as tgm
from tpu_splat_torch.sfm.mapper import MapperConfig as TMapperConfig

torch.set_num_threads(1)
TOL = 1e-9


def rotations(n, step, noise, rng):
    Rgt = [np.asarray(exp_so3(jnp.asarray(np.asarray(step) * i, jnp.float32)))
           for i in range(n)]
    pairs = chain_pairs(n)
    rels = []
    for a, b in pairs:
        R = Rgt[b] @ Rgt[a].T
        if noise:
            R = np.asarray(exp_so3(jnp.asarray(rng.normal(0, noise, 3), jnp.float32))) @ R
        rels.append(R)
    return pairs, rels


@pytest.mark.parametrize("case", ["clean", "noisy"])
def test_rotation_averaging_matches_reference(case):
    rng = np.random.default_rng(0)
    if case == "clean":
        n, (pairs, rels), ws = 12, rotations(12, [0.1, 0.3, -0.05], 0, rng), None
    else:
        n, (pairs, rels) = 16, rotations(16, [0.0, 2 * np.pi / 16, 0.0], 0.01, rng)
        ws = list(rng.uniform(20, 80, len(pairs)))
    ws = ws or [1.0] * len(pairs)
    np.testing.assert_allclose(tgm.rotation_averaging(n, pairs, rels, ws, device="cpu"),
                               jgm.rotation_averaging(n, pairs, rels, ws), atol=TOL, rtol=0)


def test_project_so3_matches_reference():
    M = np.random.default_rng(0).normal(size=(7, 3, 3))
    got = tgm._project_so3(torch.as_tensor(M)).numpy()
    np.testing.assert_allclose(got, jgm._project_so3(M), atol=TOL, rtol=0)
    assert np.allclose(np.linalg.det(got), 1.0)


def ring_dirs(n, noise, rng):
    cgt = ring(n)
    pairs = chain_pairs(n)
    dirs = []
    for a, b in pairs:
        u = cgt[b] - cgt[a]
        u = u / np.linalg.norm(u) + (rng.normal(0, noise, 3) if noise else 0)
        dirs.append(u / np.linalg.norm(u))
    return pairs, dirs


@pytest.mark.parametrize("noise", [0.0, 0.005])
def test_position_averaging_matches_reference(noise, monkeypatch):
    pairs, dirs = ring_dirs(16, noise, np.random.default_rng(0))
    w = [50.0] * len(pairs)
    want = jgm.position_averaging(16, pairs, dirs, w)
    np.testing.assert_allclose(tgm.position_averaging(16, pairs, dirs, w, device="cpu"),
                               want, atol=TOL, rtol=0)
    # the sign of the SVD's singular vectors (cuSOLVER may choose either)
    # does not matter: the baselines fix it
    svd = torch.linalg.svd
    monkeypatch.setattr(torch.linalg, "svd", lambda A, **kw: [
        -x if i == 2 else x for i, x in enumerate(svd(A, **kw))])
    np.testing.assert_allclose(tgm.position_averaging(16, pairs, dirs, w, device="cpu"),
                               want, atol=TOL, rtol=0)
    assert tgm.position_averaging(1, [], [], [], device="cpu").shape == (1, 3)


def partial_visibility(rng, n=20):
    """test_global_sfm's partial-visibility ring: each track seen by a
    5-camera window."""
    cgt = ring(n)
    pts = np.stack([0.6 * ring(n)[k] + rng.normal(0, 0.05, 3) for k in range(n)])
    pairs = [(min(i, (i + 1) % n), max(i, (i + 1) % n)) for i in range(n)]
    dirs = []
    for a, b in pairs:
        u = cgt[b] - cgt[a]
        u = u / np.linalg.norm(u) + rng.normal(0, 0.01, 3)
        dirs.append(u / np.linalg.norm(u))
    oc, ot, od = [], [], []
    for k in range(n):
        for w in range(-2, 3):
            i = (k + w) % n
            v = pts[k] - cgt[i]
            v = v / np.linalg.norm(v) + rng.normal(0, 0.005, 3)
            oc.append(i)
            ot.append(k)
            od.append(v / np.linalg.norm(v))
    return pairs, np.stack(dirs), np.asarray(oc), np.asarray(ot), np.stack(od), n


@pytest.mark.parametrize("case", ["clean", "noisy", "partial"])
def test_global_positioning_matches_reference(case):
    rng = np.random.default_rng(0)
    n = 20
    if case == "partial":
        pairs, dirs, oc, ot, od, n_tracks = partial_visibility(rng)
        w = 50.0
    else:
        noise = (0.01, 0.005) if case == "noisy" else (0.0, 0.0)
        _, pts, pairs, dirs, oc, ot, od = ref_tests.TestGlobalPositioning()._ring_scene(
            rng, n, dir_noise=noise[0], ray_noise=noise[1])
        n_tracks, w = pts.shape[0], (50.0 if case == "noisy" else 1.0)
    init = jgm.position_averaging(n, pairs, list(dirs), [w] * len(pairs))
    args = (n, init, pairs, dirs, w * np.ones(len(pairs)), oc, ot, od, np.ones(len(oc)),
            n_tracks)
    want = jgm.global_positioning(*args)
    got = tgm.global_positioning(*args, device="cpu")
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, atol=TOL, rtol=0)


def test_global_mapper_reconstruct_matches_reference(monkeypatch):
    w2c, uv = synthetic_views(n=5, n_pts=60)
    install_front_end(monkeypatch, uv)
    images = np.zeros((len(w2c), H, W, 3), np.float32)
    intr = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2)
    scenes = {}
    for pkg, mod, cfg, kw in (("ref", jgm, JMapperConfig(), {}),
                              ("port", tgm, TMapperConfig(), {"device": "cpu"})):
        logs = []
        m = mod.GlobalMapper(images, cfg, log_fn=logs.append, **intr, **kw)
        m.extract_all()
        m.match_all()
        m.build_tracks()
        scenes[pkg] = (m.reconstruct(), logs)
    (got, logs), (want, ref_logs) = scenes["port"], scenes["ref"]
    assert "global: 10 relative poses" in logs and "global: 10 relative poses" in ref_logs
    assert "global: positioning with 60 tracks / 300 rays" in logs
    np.testing.assert_array_equal(got.registered, np.asarray(want.registered))
    assert got.registered.all()
    np.testing.assert_allclose(got.cameras.camtoworlds, np.asarray(want.cameras.camtoworlds),
                               atol=1e-4, rtol=0)
    assert got.num_points == want.num_points == uv.shape[1]

"""The port's SfM slice (tpu_splat_torch/sfm/mapper.run_sfm) against the JAX
reference's run_sfm on the CPU, compared by outcome: any numeric difference
reshuffles the mapper's accept cascade (tests/test_sfm_e2e.py records drift
anywhere in a 16-44% band on the ring), so registrations, pose accuracy,
recovered focal, point counts and BA rms are held to bars, not bit for bit.

Both run without intrinsics, as the runner runs media without EXIF, so the
self-calibration path runs: the focal sweep, the focal multistart with its
rebuild, and the distortion endgame. The capture is the forward walk of
tests/test_sfm_e2e.py (its scene, cameras and mapper configuration) at 8
views, the fewest on which the reference meets that file's self-calibration
bar (4% of the span, test_sfm_self_calibration_forward_walk):
scripts/compare_torch_sfm_walk.py measures 5.6% at 7 views and 2.5% at 8.
Both are held to the tighter 3.5% of the file's walk test with the focal
given. Both packages get the
same images, rendered by the port, and run side by side in two threads to
bound the wall-clock."""

import dataclasses
import re
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_sfm_e2e import FX, H, W, _walk_cfg, make_textured_scene, walk_cameras
from tpu_splat.sfm import mapper as jmapper
from tpu_splat_torch.sfm import mapper as tmapper
from tpu_splat_torch.sfm.features import FeatureConfig
from tpu_splat_torch.testing import centre_rmse, render_capture

torch.set_num_threads(1)

N_VIEWS = 8
SPAN = 5.0  # walk_cameras' span
BAR = 0.035  # test_sfm_recovers_forward_walk's bar, as a fraction of the span
CALIBRATION_EVENTS = ("focal sweep:", "focal multistart:", "rebuilding matches",
                      "distortion multistart:")


def port_cfg(ref_cfg):
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    fields["feature"] = FeatureConfig(**dataclasses.asdict(ref_cfg.feature))
    return tmapper.MapperConfig(**fields)


def final_rms_px(logs):
    return float(re.search(r"rms ([0-9.]+)px", [s for s in logs if s.startswith("BA:")][-1])[1])


def events(logs):
    return {e for e in CALIBRATION_EVENTS if any(s.startswith(e) for s in logs)}


@pytest.fixture(scope="module")
def both_runs():
    cloud = make_textured_scene(np.random.default_rng(9))
    scene = [np.asarray(a) for a in (cloud.means, cloud.scales, cloud.quats, cloud.opacities,
                                     cloud.sh0, cloud.shN)]
    viewmats = walk_cameras(n_views=N_VIEWS)
    images = render_capture(scene, viewmats, FX, W, H)
    ref_logs, port_logs = [], []
    with ThreadPoolExecutor(2) as pool:  # no intrinsics: self-calibration
        ref = pool.submit(jmapper.run_sfm, images, _walk_cfg(), log_fn=ref_logs.append)
        got = pool.submit(tmapper.run_sfm, images, port_cfg(_walk_cfg()),
                          log_fn=port_logs.append, device="cpu")
        return viewmats, (ref.result(), ref_logs), (got.result(), port_logs)


def test_run_sfm_matches_reference_outcome(both_runs):
    """Both take the same calibration steps; registered counts within 1; both
    camera-centre RMSEs under 3.5% of the span; both recovered focals within
    15% of the true one (a forward walk trades focal against depth: the
    reference's walk test notes its focal landing about 12% low); point
    counts within 20%; the port's final BA rms at most 1.25x the
    reference's; every pose and point finite."""
    viewmats, (ref, ref_logs), (got, port_logs) = both_runs
    reg_r, reg_g = int(np.asarray(ref.registered).sum()), int(got.registered.sum())
    fx_r, fx_g = float(np.asarray(ref.cameras.fx)[0]), float(got.cameras.fx[0])
    # the outcome on record (shown with pytest -s)
    print(f"\nself-calibrated run_sfm on the {N_VIEWS}-view walk, reference / port: "
          f"registered {reg_r} / {reg_g}, points {ref.num_points} / {got.num_points}, "
          f"fx {fx_r:.1f} / {fx_g:.1f} (true {FX}), camera-centre RMSE "
          f"{centre_rmse(ref, viewmats) / SPAN:.4f} / {centre_rmse(got, viewmats) / SPAN:.4f} "
          f"of the span, final BA rms {final_rms_px(ref_logs)} / {final_rms_px(port_logs)} px, "
          f"calibration steps {sorted(events(ref_logs))} / {sorted(events(port_logs))}")
    assert events(port_logs) == events(ref_logs) and "focal sweep:" in events(ref_logs)
    assert abs(reg_r - reg_g) <= 1 and reg_g >= N_VIEWS - 1, (reg_r, reg_g, port_logs)
    for name, scene, logs in (("reference", ref, ref_logs), ("port", got, port_logs)):
        rmse = centre_rmse(scene, viewmats)
        assert rmse < BAR * SPAN, f"{name}: camera-centre RMSE {rmse:.4f}; log: {logs}"
    assert abs(fx_r - FX) <= 0.15 * FX and abs(fx_g - FX) <= 0.15 * FX, (fx_r, fx_g)
    n_r, n_g = ref.num_points, got.num_points
    assert abs(n_g - n_r) <= 0.2 * n_r, (n_r, n_g)
    assert final_rms_px(port_logs) <= 1.25 * final_rms_px(ref_logs)
    assert np.isfinite(got.cameras.camtoworlds).all() and np.isfinite(got.points).all()
    assert got.points.shape == (n_g, 3) and got.cameras.camtoworlds.shape == (reg_g, 4, 4)


def test_run_sfm_database_arguments_are_not_ported_yet():
    images = np.zeros((2, 32, 32, 3), np.float32)
    for kw in ({"colmap_database": "db.db"}, {"export_database": "db.db"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmapper.run_sfm(images, device="cpu", **kw)


@pytest.mark.parametrize("second", ["no init pair", "device failure"])
def test_init_pair_retry_catches_only_its_own_failure(monkeypatch, second):
    """After a first attempt registers too little, a retry that finds no init
    pair keeps the first map, while any other RuntimeError (a cuSOLVER or CUDA
    failure, say) propagates."""
    m = tmapper.IncrementalMapper(np.zeros((8, 32, 32, 3), np.float32), tmapper.MapperConfig(),
                                  fx=30.0, device="cpu")
    m.tracks = []
    calls = []

    def fake_reconstruct():
        calls.append(len(calls))
        if len(calls) == 1:
            m.R, m.t = np.zeros((8, 3, 3), np.float32), np.zeros((8, 3), np.float32)
            m.registered, m.points = np.arange(8) < 2, np.zeros((0, 3), np.float32)
            m.has_point, m._init_pair = np.zeros(0, bool), (0, 1)
            return SimpleNamespace(registered=m.registered)
        if second == "no init pair":
            raise tmapper._NoInitPair("SfM failed to converge: no initialization pair left")
        raise RuntimeError("cusolver error: CUSOLVER_STATUS_INVALID_VALUE")

    monkeypatch.setattr(m, "_reconstruct", fake_reconstruct)
    monkeypatch.setattr(m, "_merge_submodels", lambda best, attempts: None)
    if second == "no init pair":
        assert m.reconstruct().registered.sum() == 2
    else:
        with pytest.raises(RuntimeError, match="CUSOLVER"):
            m.reconstruct()
    assert len(calls) == 2

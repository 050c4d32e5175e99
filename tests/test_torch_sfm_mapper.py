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
given. Both packages get the same images, rendered by the port.

The JAX package is frozen and the capture is fixed, so the reference's half
of the comparison never changes: it is recorded below (REFERENCE), with the
capture's statistics, by `JAX_PLATFORMS=cpu python
scripts/compare_torch_sfm_walk.py --record`. The slice test runs the port
live against the record, after checking that its capture is the recorded
one; the slow test test_reference_outcome_matches_record re-runs the
reference and checks the record; it runs only when selected (`python -m
pytest tests/test_torch_sfm_mapper.py -m slow`)."""

import dataclasses
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_sfm_e2e import FX, H, W, _walk_cfg, make_textured_scene, walk_cameras
from tpu_splat_torch.sfm import mapper as tmapper
from tpu_splat_torch.sfm.features import FeatureConfig
from tpu_splat_torch.testing import centre_rmse, render_capture

torch.set_num_threads(1)

N_VIEWS = 8
SPAN = 5.0  # walk_cameras' span
BAR = 0.035  # test_sfm_recovers_forward_walk's bar, as a fraction of the span
CALIBRATION_EVENTS = ("focal sweep:", "focal multistart:", "rebuilding matches",
                      "distortion multistart:")

# The reference's self-calibrated run_sfm on the capture below (rmse in world
# units), and the capture's mean and its values at CAPTURE_PIXELS (view, y,
# x, channel): `JAX_PLATFORMS=cpu python scripts/compare_torch_sfm_walk.py
# --record`.
REFERENCE = {'registered': 8, 'points': 488, 'fx': 130.4790496826172,
             'rmse': 0.12493296712636948, 'final_rms_px': 0.63,
             'events': ['distortion multistart:', 'focal multistart:', 'focal sweep:',
                        'rebuilding matches']}
CAPTURE_PIXELS = [(0, 80, 80, 0), (1, 20, 140, 1), (3, 150, 10, 2), (4, 95, 61, 0),
                  (6, 5, 5, 1), (7, 120, 100, 2)]
CAPTURE_MEAN = 0.61200350522995
CAPTURE_VALUES = [0.2316, 0.771198, 0.7, 0.073186, 0.610151, 0.509213]
CAPTURE_TOL = 1e-4


def port_cfg(ref_cfg):
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    fields["feature"] = FeatureConfig(**dataclasses.asdict(ref_cfg.feature))
    return tmapper.MapperConfig(**fields)


def final_rms_px(logs):
    return float(re.search(r"rms ([0-9.]+)px", [s for s in logs if s.startswith("BA:")][-1])[1])


def events(logs):
    return {e for e in CALIBRATION_EVENTS if any(s.startswith(e) for s in logs)}


@pytest.fixture(scope="module")
def capture():
    cloud = make_textured_scene(np.random.default_rng(9))
    scene = [np.asarray(a) for a in (cloud.means, cloud.scales, cloud.quats, cloud.opacities,
                                     cloud.sh0, cloud.shN)]
    viewmats = walk_cameras(n_views=N_VIEWS)
    return viewmats, render_capture(scene, viewmats, FX, W, H)


def assert_recorded_capture(images):
    """The capture is the one the reference's outcome was recorded on."""
    assert images.shape == (N_VIEWS, H, W, 3)
    assert abs(float(images.mean()) - CAPTURE_MEAN) <= CAPTURE_TOL
    got = [float(images[p]) for p in CAPTURE_PIXELS]
    np.testing.assert_allclose(got, CAPTURE_VALUES, atol=CAPTURE_TOL, rtol=0)


def test_run_sfm_matches_reference_outcome(capture):
    """Both take the same calibration steps; registered counts within 1; both
    camera-centre RMSEs under 3.5% of the span; both recovered focals within
    15% of the true one (a forward walk trades focal against depth: the
    reference's walk test notes its focal landing about 12% low); point
    counts within 20%; the port's final BA rms at most 1.25x the
    reference's; every pose and point finite. The reference's half is the
    record."""
    viewmats, images = capture
    assert_recorded_capture(images)
    port_logs = []  # no intrinsics: self-calibration
    got = tmapper.run_sfm(images, port_cfg(_walk_cfg()), log_fn=port_logs.append,
                          device="cpu")
    ref = SimpleNamespace(**REFERENCE)
    reg_r, reg_g = ref.registered, int(got.registered.sum())
    fx_r, fx_g = ref.fx, float(got.cameras.fx[0])
    # the outcome on record (shown with pytest -s)
    print(f"\nself-calibrated run_sfm on the {N_VIEWS}-view walk, reference / port: "
          f"registered {reg_r} / {reg_g}, points {ref.points} / {got.num_points}, "
          f"fx {fx_r:.1f} / {fx_g:.1f} (true {FX}), camera-centre RMSE "
          f"{ref.rmse / SPAN:.4f} / {centre_rmse(got, viewmats) / SPAN:.4f} "
          f"of the span, final BA rms {ref.final_rms_px} / {final_rms_px(port_logs)} px, "
          f"calibration steps {ref.events} / {sorted(events(port_logs))}")
    assert events(port_logs) == set(ref.events) and "focal sweep:" in ref.events
    assert abs(reg_r - reg_g) <= 1 and reg_g >= N_VIEWS - 1, (reg_r, reg_g, port_logs)
    for name, rmse, logs in (("reference", ref.rmse, "on record"),
                             ("port", centre_rmse(got, viewmats), port_logs)):
        assert rmse < BAR * SPAN, f"{name}: camera-centre RMSE {rmse:.4f}; log: {logs}"
    assert abs(fx_r - FX) <= 0.15 * FX and abs(fx_g - FX) <= 0.15 * FX, (fx_r, fx_g)
    n_r, n_g = ref.points, got.num_points
    assert abs(n_g - n_r) <= 0.2 * n_r, (n_r, n_g)
    assert final_rms_px(port_logs) <= 1.25 * ref.final_rms_px
    assert np.isfinite(got.cameras.camtoworlds).all() and np.isfinite(got.points).all()
    assert got.points.shape == (n_g, 3) and got.cameras.camtoworlds.shape == (reg_g, 4, 4)


@pytest.mark.slow
def test_reference_outcome_matches_record(capture, request):
    """The reference's self-calibrated run_sfm on the capture reproduces the
    record: counts and calibration steps exactly, the focal, RMSE and BA rms
    within 1e-3 relative (XLA's CPU code may round differently on another
    host). It runs only when selected by its marker (-m slow)."""
    from tpu_splat.sfm import mapper as jmapper

    if "slow" not in request.config.getoption("markexpr"):
        pytest.skip("re-runs the reference's whole run_sfm (minutes): select it with -m slow")
    viewmats, images = capture
    assert_recorded_capture(images)
    logs = []
    out = jmapper.run_sfm(images, _walk_cfg(), log_fn=logs.append)
    assert int(np.asarray(out.registered).sum()) == REFERENCE["registered"]
    assert out.num_points == REFERENCE["points"]
    assert sorted(events(logs)) == REFERENCE["events"]
    for key, value in (("fx", float(np.asarray(out.cameras.fx)[0])),
                       ("rmse", centre_rmse(out, viewmats)), ("final_rms_px", final_rms_px(logs))):
        assert value == pytest.approx(REFERENCE[key], rel=1e-3), key


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

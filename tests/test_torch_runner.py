"""The port's job config, runner and CLI (tpu_splat_torch/core/config.py,
pipeline/{component,runner,sink}.py, cli/main.py) against the JAX package's.

A default job runs in both packages on one zip of 12 seeded 64x48 frames,
with run_sfm and train_splat replaced in each by the same fast fake (a fixed
scene with a nonzero k1, and a fixed cloud), so every other stage runs for
real: ingest, blur filtering, undistortion, the COLMAP model, the delivery
rotation and the artifact sink. The component graph, artifacts, metrics, job
store, undistorted frames and delivered bytes are compared. So are the
matting and spherical components (a --remove-background job, the human-
subject removal with and without a masks/ directory, the 360-degree
expansion), the generator's job JSON (cli/generate_splat.py), the two
pose-prior jobs (a transforms.json of ARKit poses, a COLMAP model with a
radial k1; sfm_with_pose_priors faked too) and the functions every optional
component runs (pose priors, glomap, the extras)."""

import dataclasses
import json
import logging
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_config import REFERENCE_JOB
from tpu_splat.core import config as jconfig
from tpu_splat.core import types as jtypes
from tpu_splat.core.errors import PipelineError as JPipelineError
from tpu_splat.pipeline import component as jcomp
from tpu_splat.pipeline import runner as jrunner
from tpu_splat_torch.cli import main as tcli
from tpu_splat_torch.core import config as tconfig
from tpu_splat_torch.core import types as ttypes
from tpu_splat_torch.core.errors import PipelineError as TPipelineError
from tpu_splat_torch.pipeline import component as tcomp
from tpu_splat_torch.pipeline import runner as trunner

torch.set_num_threads(1)

W, H, N = 64, 48, 12
K1 = -0.08
SPARSE = ["cameras.bin", "cameras.txt", "images.bin", "images.txt", "points3D.bin",
          "points3D.txt"]


def test_job_config_parses_and_round_trips_like_reference():
    for payload in (REFERENCE_JOB, {}, {"training": {"maxSteps": "600", "rotateSplat": "0"}}):
        got, want = tconfig.job_config_from_json(payload), jconfig.job_config_from_json(payload)
        if not payload.get("uuid"):
            got.uuid = want.uuid  # a fresh uuid4 each
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert tconfig.job_config_to_json(got) == jconfig.job_config_to_json(want)
        again = tconfig.job_config_from_json(json.dumps(tconfig.job_config_to_json(got)))
        assert dataclasses.asdict(again) == dataclasses.asdict(got)
    assert dataclasses.asdict(tconfig.JobConfig(uuid="u")) == \
        dataclasses.asdict(jconfig.JobConfig(uuid="u"))
    for bad in ({"sfm": {"matchingMethod": "nope"}}, {"training": {"model": "nope"}}):
        with pytest.raises(TPipelineError) as e:
            tconfig.job_config_from_json(bad)
        with pytest.raises(JPipelineError) as e_ref:
            jconfig.job_config_from_json(bad)
        assert str(e.value) == str(e_ref.value)


def graph(pkg, cfg):
    comp, runner = (tcomp, trunner) if pkg == "port" else (jcomp, jrunner)
    pipe = comp.Pipeline(name="g")
    if pkg == "port":
        runner._register_components(pipe, cfg)
    else:
        runner._register_components(pipe, cfg, "")
    return [(c.name, c.ctype.value, c.error_code, c.enabled) for c in pipe.components]


def test_component_graph_matches_reference():
    for payload in ({}, REFERENCE_JOB, {"segmentation": {"removeBackground": "true"},
                                        "measurement": {"referenceType": "tripod"},
                                        "training": {"model": "nerfacto"}},
                    {"sfm": {"softwareName": "glomap",
                             "posePriors": {"usePosePriorTransformJson": {"enable": "true"}}},
                     "semantic": {"enableObjectLayer": "true"}}):
        assert graph("port", tconfig.job_config_from_json(payload)) == \
            graph("ref", jconfig.job_config_from_json(payload))


def seeded_zip(path, n=N, w=W, h=H):
    import cv2

    rng = np.random.default_rng(12)
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(n):
            img = cv2.resize(rng.uniform(0, 255, (h // 4, w // 4, 3)).astype(np.float32),
                             (w, h), interpolation=cv2.INTER_CUBIC)
            ok, png = cv2.imencode(".png", np.clip(img, 0, 255).astype(np.uint8))
            zf.writestr(f"capture/frame_{i:03d}.png", png.tobytes())
    return path


def fake_arrays(n_reg):
    rng = np.random.default_rng(13)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n_reg, 1, 1))
    c2w[:, :3, 3] = rng.normal(0, 1, (n_reg, 3))
    cams = dict(camtoworlds=c2w, fx=np.full(n_reg, 55.0, np.float32),
                fy=np.full(n_reg, 55.0, np.float32), cx=np.full(n_reg, 32.0, np.float32),
                cy=np.full(n_reg, 24.0, np.float32),
                distortion=np.tile(np.array([[K1, 0, 0, 0]], np.float32), (n_reg, 1)))
    p = 60
    pts = dict(points=rng.normal(0, 2, (p, 3)).astype(np.float32),
               point_colors=rng.uniform(0, 1, (p, 3)).astype(np.float32),
               point_errors=rng.uniform(0, 1, p).astype(np.float32),
               track_counts=np.full(p, 2, np.int32))
    g = 40
    cloud = dict(means=rng.normal(0, 1, (g, 3)), scales=rng.normal(-3, 0.3, (g, 3)),
                 quats=rng.normal(0, 1, (g, 4)), opacities=rng.normal(0, 1, g),
                 sh0=rng.normal(0, 0.3, (g, 3)), shN=rng.normal(0, 0.05, (g, 15, 3)))
    return cams, pts, {k: v.astype(np.float32) for k, v in cloud.items()}


@pytest.fixture
def fakes(monkeypatch):
    """Patch both packages' run_sfm and train_splat with the same fakes;
    returns what each fake was called with, by package."""
    from tpu_splat.gs import pipeline as jgs
    from tpu_splat.sfm import colmap_db as jdb
    from tpu_splat.sfm import mapper as jmapper
    from tpu_splat_torch.gs import pipeline as tgs
    from tpu_splat_torch.sfm import colmap_db as tdb
    from tpu_splat_torch.sfm import mapper as tmapper

    calls = {"ref": {}, "port": {}}
    state = {"n_reg": N - 1}

    def make(pkg, types, db, wrap):
        def run_sfm(images, cfg, fx=None, fy=None, log_fn=None, export_database=None,
                    **kw):
            calls[pkg]["sfm"] = dict(images=images, fx=fx, kw=kw)
            n_reg = state["n_reg"]
            cams, pts, _ = fake_arrays(n_reg)
            db.write_database(export_database, W, H, 55.0, 55.0, 32.0, 24.0,
                              [f"f{i}" for i in range(len(images))],
                              keypoints=[np.zeros((4, 2), np.float32)] * len(images), k1=K1)
            log_fn("sfm timers [done]: fake")
            reg = np.arange(len(images)) != 3
            reg[n_reg + 1:] = False
            return types.SfMScene(
                cameras=types.Cameras(**{k: wrap(v) for k, v in cams.items()}, width=W,
                                      height=H),
                **{k: wrap(v) for k, v in pts.items()}, registered=wrap(reg))

        def train_splat(scene, images, **kw):
            calls[pkg]["train"] = dict(scene=scene, images=images, kw=kw)
            cloud = types.GaussianCloud(**{k: wrap(v) for k, v in fake_arrays(1)[2].items()})
            return cloud, {"num_gaussians": 40.0, "psnr": 21.5, "train_steps": 7.0}
        return run_sfm, train_splat

    for pkg, types, db, mapper, gs, wrap in (
            ("ref", jtypes, jdb, jmapper, jgs, jnp.asarray),
            ("port", ttypes, tdb, tmapper, tgs, lambda a: a)):
        run_sfm, train_splat = make(pkg, types, db, wrap)
        monkeypatch.setattr(mapper, "run_sfm", run_sfm)
        monkeypatch.setattr(gs, "train_splat", train_splat)
    return calls, state


def run_both(tmp_path, payload, zip_path):
    out = {}
    for pkg, config, runner in (("ref", jconfig, jrunner), ("port", tconfig, trunner)):
        cfg = config.job_config_from_json(
            dict(payload, uuid="job-1", inputPath=zip_path, outputPath=str(tmp_path / pkg)))
        kw = {"device": "cpu"} if pkg == "port" else {}
        out[pkg] = runner.run_job(cfg, **kw)
    return out


def test_default_job_matches_reference(tmp_path, fakes):
    calls, _ = fakes
    zip_path = seeded_zip(str(tmp_path / "capture.zip"))
    res = run_both(tmp_path, {"training": {"maxSteps": 7}}, zip_path)
    got, want = res["port"], res["ref"]
    assert got.status == want.status == "Complete"
    assert list(got.timings) == list(want.timings) == [
        "Resolve-Input", "Media-To-Images", "Filter-Blurry-Images", "SfM", "Quality-Gate",
        "Train-Stage1", "Export-Splat", "Rotate-Mirror-SPZ-Export", "Artifact-Export"]
    assert got.metrics == want.metrics and got.metrics["num_registered"] == N - 1

    def rel(res, pkg):
        return {k: os.path.relpath(v, tmp_path / pkg) for k, v in res.artifacts.items()}
    assert rel(got, "port") == rel(want, "ref") == {
        k: f"workflow-output/job-1/{f}" for k, f in (
            ("colmap_db", "database.db"), ("transforms_json", "transforms.json"),
            ("ply", "splat.ply"), ("spz", "splat.spz"))}
    stores = [json.load(open(tmp_path / pkg / "jobs" / "job-1.json")) for pkg in ("port", "ref")]
    assert stores[0]["status"] == stores[1]["status"] == "Complete"
    assert stores[0].keys() == stores[1].keys()
    assert stores[0]["timings"].keys() == stores[1]["timings"].keys()

    # the same frames reach SfM; the undistorted registered frames reach training
    np.testing.assert_array_equal(calls["port"]["sfm"]["images"], calls["ref"]["sfm"]["images"])
    assert calls["port"]["sfm"]["kw"] == {"device": torch.device("cpu")}
    t_got, t_want = calls["port"]["train"], calls["ref"]["train"]
    assert t_got["images"].shape == (N - 1, H, W, 3)
    assert not np.allclose(t_got["images"], calls["port"]["sfm"]["images"][np.arange(N) != 3])
    np.testing.assert_allclose(t_got["images"], t_want["images"], atol=1e-5, rtol=0)
    assert not np.asarray(t_got["scene"].cameras.distortion).any()
    assert not np.asarray(t_want["scene"].cameras.distortion).any()
    for key in ("model", "max_steps", "downscale_factor", "masks", "resume", "checkpoint_dir"):
        v_got, v_want = t_got["kw"][key], t_want["kw"][key]
        if key == "checkpoint_dir":
            v_got, v_want = (os.path.relpath(v_got, tmp_path / "port"),
                             os.path.relpath(v_want, tmp_path / "ref"))
        assert v_got == v_want, key
    assert t_got["kw"]["checkpoint_dir"].endswith("checkpoints") and t_got["kw"]["resume"]
    assert t_got["kw"]["device"] == torch.device("cpu")

    for sub in [os.path.join("colmap", "sparse", "0", f) for f in SPARSE] + [
            os.path.join("colmap", "transforms.json"), os.path.join("exports", "splat.spz"),
            os.path.join("exports", "splat.ply")]:
        assert (tmp_path / "port" / sub).read_bytes() == (tmp_path / "ref" / sub).read_bytes(), \
            sub


def test_error_codes_match_reference(tmp_path, fakes):
    _, state = fakes
    zip_path = seeded_zip(str(tmp_path / "capture.zip"))
    single = str(tmp_path / "one.png")
    with zipfile.ZipFile(zip_path) as zf:
        open(single, "wb").write(zf.read("capture/frame_000.png"))
    state["n_reg"] = 8  # below the splatfacto gate's 10 frames
    for case, path, code in (("missing", str(tmp_path / "nope.mp4"), 710),
                             ("single", single, 705), ("gate", zip_path, 755)):
        errors = {}
        for pkg, config, runner, err in (("ref", jconfig, jrunner, JPipelineError),
                                         ("port", tconfig, trunner, TPipelineError)):
            cfg = config.job_config_from_json(
                {"uuid": case, "inputPath": path, "outputPath": str(tmp_path / case / pkg)})
            kw = {"device": "cpu"} if pkg == "port" else {}
            with pytest.raises(err) as e:
                runner.run_job(cfg, **kw)
            store = json.load(open(tmp_path / case / pkg / "jobs" / f"{case}.json"))
            errors[pkg] = (e.value.code, str(e.value), store["status"], store["code"])
        assert errors["port"] == errors["ref"] and errors["port"][0] == code, case


def test_portrait_capture_gets_the_y_rotation_of_the_reference(tmp_path):
    _, _, arrays = fake_arrays(1)
    for shape, y in (((3, 96, 64, 3), 90), ((3, 64, 96, 3), 180)):
        for pkg, comp, runner, config, types, wrap in (
                ("ref", jcomp, jrunner, jconfig, jtypes, jnp.asarray),
                ("port", tcomp, trunner, tconfig, ttypes, lambda a: a)):
            ctx = comp.PipelineContext(cfg=config.JobConfig(uuid="p"),
                                       out_dir=str(tmp_path / f"{pkg}{y}"))
            ctx["splat"] = types.GaussianCloud(**{k: wrap(v) for k, v in arrays.items()})
            ctx["images"] = np.zeros(shape, np.float32)
            runner._export_spz(ctx)
        for f in ("splat.spz", "splat.ply"):
            assert (tmp_path / f"port{y}" / "exports" / f).read_bytes() == \
                (tmp_path / f"ref{y}" / "exports" / f).read_bytes()
    assert (tmp_path / "port90/exports/splat.spz").read_bytes() != \
        (tmp_path / "port180/exports/splat.spz").read_bytes()


@pytest.mark.parametrize("payload", [
    {"sfm": {"posePriors": {"usePosePriorColmapModelFiles": "true"}}},
    {"sfm": {"posePriors": {"usePosePriorTransformJson": {"enable": "true"}}}},
    {"sfm": {"softwareName": "glomap"}},
    {"training": {"model": "nerfacto"}},
    {"measurement": {"referenceType": "tripod"}},
    {"semantic": {"enableObjectLayer": "true"}},
    {"segmentation": {"removeBackground": "true"}},
    {"segmentation": {"removeHumanSubject": "true"}},
    {"imageProcessing": {"blurMaskMethod": "u2net"}},
    {"sphericalCamera": {"enable": "true"}},
], ids=lambda p: next(iter(p)) + "-" + next(iter(next(iter(p.values())))))
def test_optional_components_are_ported(payload):
    """Every option runs the port of the reference's function (same names,
    same enabled components), not a refusal; glomap swaps SfM's mapper
    inside the same _sfm, as in the reference."""
    pipe = tcomp.Pipeline(name="g")
    trunner._register_components(pipe, tconfig.job_config_from_json(payload))
    enabled = [c for c in pipe.components if c.enabled]
    ref = jcomp.Pipeline(name="g")
    jrunner._register_components(ref, jconfig.job_config_from_json(payload), "")
    assert [c.fn.__name__ for c in enabled] == [c.fn.__name__ for c in ref.components
                                                if c.enabled]
    assert all(getattr(trunner, c.fn.__name__) is c.fn for c in enabled)


def composite_zip(path, n=N, w=W, h=H):
    """testing.composite_scene's subject capture as 8-bit PNGs in a zip."""
    import cv2

    from tpu_splat_torch.testing import composite_scene

    images, _ = composite_scene(n=n, h=h, w=w)
    with zipfile.ZipFile(path, "w") as zf:
        for i, img in enumerate(images):
            png = cv2.imencode(".png", (img[..., ::-1] * 255).round().astype(np.uint8))[1]
            zf.writestr(f"capture/frame_{i:03d}.png", png.tobytes())
    return path


def test_remove_background_job_matches_reference(tmp_path, fakes):
    """A --remove-background job: the same frames are kept and masked, and
    the masks of the registered frames, undistorted like the frames, reach
    training (binary masks may differ in 0.1% of pixels, where MatNet's
    saliency sits at 0.5)."""
    calls, state = fakes
    state["n_reg"] = 10  # of the 11 frames the blur filter keeps
    zip_path = composite_zip(str(tmp_path / "capture.zip"))
    res = run_both(tmp_path, {"segmentation": {"removeBackground": "true"},
                              "videoProcessing": {"maxNumImages": 11},
                              "training": {"maxSteps": 7}}, zip_path)
    assert res["port"].status == res["ref"].status == "Complete"
    assert list(res["port"].timings) == list(res["ref"].timings)
    assert "Remove-Background" in res["port"].timings
    got, want = calls["port"]["sfm"]["images"], calls["ref"]["sfm"]["images"]
    assert got.shape == want.shape == (11, H, W, 3)
    assert np.mean(np.abs(got - want) > 1e-4) <= 1e-3
    assert 0.05 < np.mean(got.max(axis=-1) > 0) < 0.8  # the subject is kept
    m_got, m_want = calls["port"]["train"]["kw"]["masks"], calls["ref"]["train"]["kw"]["masks"]
    assert m_got.shape == np.asarray(m_want).shape == (10, H, W)  # the registered frames
    assert np.mean(np.abs(m_got - np.asarray(m_want)) > 1e-4) <= 1e-3


@pytest.mark.parametrize("mask_dir", [True, False], ids=["masks-dir", "person-matting"])
def test_remove_human_subject_matches_reference(tmp_path, mask_dir):
    """With a masks/ directory beside the frames (one mask per raw frame,
    picked by the blur filter's indices) the reference's Otsu contract
    applies, exactly; without one the person-segmentation matting runs.
    Either way the masks kept are the complement, times earlier masks."""
    import cv2

    from tpu_splat_torch.testing import composite_scene

    images, gt = composite_scene(n=6, h=H, w=W)
    raw = tmp_path / "capture"
    raw.mkdir()
    if mask_dir:
        (raw / "masks").mkdir()
        for i in range(8):
            m = gt[min(i, 5)] * 255 if i % 2 == 0 else cv2.GaussianBlur(gt[min(i, 5)], (5, 5),
                                                                        1.5) * 255
            cv2.imwrite(str(raw / "masks" / f"m{i:02d}.png"), m.astype(np.uint8))
    prior = np.ones((6, H, W), np.float32)
    prior[:, :4] = 0
    out = {}
    for pkg, comp, runner, config in (("ref", jcomp, jrunner, jconfig),
                                      ("port", tcomp, trunner, tconfig)):
        ctx = comp.PipelineContext(cfg=config.JobConfig(uuid="h"), out_dir=str(tmp_path))
        if pkg == "port":
            ctx["device"] = torch.device("cpu")
        ctx.update(images=images.copy(), raw_dir=str(raw), masks=prior.copy(),
                   frame_indices=np.array([0, 1, 2, 4, 6, 7]))
        runner._remove_human_subject(ctx)
        out[pkg] = (ctx["images"], ctx["masks"])
    (gi, gm), (wi, wm) = out["port"], out["ref"]
    assert gm.shape == (6, H, W) and not gm[:, :4].any()
    if mask_dir:
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gi, wi)
        assert 0.3 < gm.mean() < 0.95
    else:
        assert np.mean(gm != wm) <= 1e-3
        assert np.mean(np.abs(gi - wi) > 1e-6) <= 1e-3


def test_spherical_component_matches_reference(tmp_path):
    """The expansion replaces the frames with the reference's views, in its
    order, at the default face size (256 for these 64x128 frames)."""
    images = np.random.default_rng(6).uniform(0, 1, (3, 64, 128, 3)).astype(np.float32)
    payload = {"sphericalCamera": {"enable": "true", "cubeFacesToRemove": "up,down",
                                   "useOvalNodes": "true"}}
    out = {}
    for pkg, comp, runner, config in (("ref", jcomp, jrunner, jconfig),
                                      ("port", tcomp, trunner, tconfig)):
        ctx = comp.PipelineContext(cfg=config.job_config_from_json(payload),
                                   out_dir=str(tmp_path))
        if pkg == "port":
            ctx["device"] = torch.device("cpu")
        ctx["images"] = images
        runner._spherical(ctx)
        out[pkg] = ctx["images"]
    assert out["port"].shape == out["ref"].shape == (3 * 4 + 3 * 3 * 4, 256, 256, 3)
    np.testing.assert_allclose(out["port"], out["ref"], atol=1e-5, rtol=0)


def test_generate_splat_writes_the_reference_job_and_runs_it(tmp_path, fakes, capsys):
    from tpu_splat.cli import generate_splat as jgen
    from tpu_splat_torch.cli import generate_splat as tgen

    assert tgen.PRESETS == jgen.PRESETS
    for preset in tgen.PRESETS:
        for bg in (False, True):
            for sph in (False, True):
                args = ("in/capture.zip", "out", preset, "splatfacto", bg, sph, "u-1")
                got, want = tgen.build_job_json(*args), jgen.build_job_json(*args)
                assert got.pop("instanceType") and want.pop("instanceType")
                assert got == want
                cfg = tconfig.job_config_from_json(got)
                assert cfg.segmentation.remove_background == bg
                assert cfg.spherical_camera.enable == sph
    assert tgen.build_job_json("a.mp4")["uuid"] != tgen.build_job_json("a.mp4")["uuid"]

    zip_path = seeded_zip(str(tmp_path / "capture.zip"))
    out = str(tmp_path / "out")
    assert tgen.main([zip_path, "-o", out, "--preset", "fast", "--job-only"]) == 0
    job_path = capsys.readouterr().out.strip().split("job JSON: ")[1]
    job = json.load(open(job_path))
    assert job["sfm"]["matchingMethod"] == "sequential" and job["training"]["maxSteps"] == 5000
    assert os.listdir(out) == [os.path.basename(job_path)]
    assert tgen.main([zip_path, "-o", out, "--remove-background", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out
    res = json.loads(lines[lines.index("{"):])
    assert res["status"] == "Complete" and "Remove-Background" in res["timings"]


def test_multi_gpu_flag_trains_on_one_card_and_is_refused_with_two(tmp_path, fakes,
                                                                   monkeypatch, caplog):
    """enableMultiGpu dispatches as the reference's runner does: data-parallel
    training (train_splat(distributed=True)) for a CUDA job with more than
    one card, one card with the reference's log line otherwise. (Before the
    multi-card port, a job with two cards was refused; it now trains on both.)"""
    calls, _ = fakes
    zip_path = seeded_zip(str(tmp_path / "capture.zip"))
    payload = {"inputPath": zip_path, "outputPath": str(tmp_path / "out"),
               "training": {"enableMultiGpu": "true", "maxSteps": 3}}
    lines = []
    res = trunner.run_job(tconfig.job_config_from_json(payload), log_fn=lines.append,
                          device="cpu")
    assert res.status == "Complete" and "train" in calls["port"]
    assert calls["port"]["train"]["kw"]["distributed"] is False
    assert any("only one device present" in s for s in lines)
    assert any(s.startswith("sfm timers") for s in lines)  # the bridged pipeline logger
    assert logging.getLogger(trunner.LOGGER).handlers == []

    # the dispatch itself, for a CUDA job with two cards and with one
    cfg = tconfig.job_config_from_json(payload)
    ctx = tcomp.PipelineContext(cfg=cfg, out_dir=str(tmp_path / "out2"), scene=object(),
                                images=np.zeros((2, H, W, 3), np.float32),
                                device=torch.device("cuda"))
    for n_cards, distributed in ((2, True), (1, False)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=trunner.LOGGER):
            trunner._train(ctx)
        kw = calls["port"]["train"]["kw"]
        assert kw["distributed"] is distributed and kw["device"] == torch.device("cuda")
        assert ("only one device present" in caplog.text) is not distributed
    # a CPU job stays on one process, whatever the card count
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    trunner._train(tcomp.PipelineContext(ctx, device=torch.device("cpu")))
    assert calls["port"]["train"]["kw"]["distributed"] is False


def test_cli_run_and_status(tmp_path, fakes, capsys):
    zip_path = seeded_zip(str(tmp_path / "capture.zip"))
    job = tmp_path / "job.json"
    job.write_text(json.dumps({"uuid": "cli-1", "inputPath": zip_path,
                               "outputPath": str(tmp_path / "out"),
                               "training": {"maxSteps": 5}}))
    assert tcli.main(["run", str(job), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["uuid"] == "cli-1" and out["status"] == "Complete"
    assert set(out["artifacts"]) == {"colmap_db", "transforms_json", "ply", "spz"}
    assert out["metrics"]["num_registered"] == N - 1 and "SfM" in out["timings"]
    assert tcli.main(["status", str(tmp_path / "out"), "cli-1"]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status["status"] == "Complete" and status["artifacts"] == out["artifacts"]
    assert tcli.main(["run", "--input", str(tmp_path / "none.zip"), "--output",
                      str(tmp_path / "out3"), "--device", "cpu"]) == 1
    assert "[710]" in capsys.readouterr().err


@pytest.fixture
def prior_fakes(fakes, monkeypatch):
    """`fakes`, plus both packages' sfm_with_pose_priors replaced by one that
    records its arguments and returns the priors as the scene (every frame
    registered), with fake_arrays' points."""
    from tpu_splat.sfm import pose_priors as jpp
    from tpu_splat_torch.sfm import pose_priors as tpp

    calls, state = fakes
    for pkg, pp, types, wrap in (("ref", jpp, jtypes, jnp.asarray),
                                 ("port", tpp, ttypes, lambda a: a)):
        def fake(images, c2ws, fx, fy, cx, cy, mapper_cfg=None, log_fn=None, pkg=pkg,
                 types=types, wrap=wrap, **kw):
            calls[pkg]["priors"] = dict(images=images, c2ws=c2ws, intrin=(fx, fy, cx, cy),
                                        kw=kw)
            n = len(images)
            _, pts, _ = fake_arrays(n)
            cams = types.Cameras(
                camtoworlds=wrap(c2ws.astype(np.float32)), fx=wrap(np.full(n, fx, np.float32)),
                fy=wrap(np.full(n, fy, np.float32)), cx=wrap(np.full(n, cx, np.float32)),
                cy=wrap(np.full(n, cy, np.float32)), distortion=wrap(np.zeros((n, 4), np.float32)),
                width=W, height=H)
            return types.SfMScene(cameras=cams, **{k: wrap(v) for k, v in pts.items()},
                                  registered=wrap(np.ones(n, bool)))
        monkeypatch.setattr(pp, "sfm_with_pose_priors", fake)
    return calls, state


def prior_poses(n):
    """Seeded camera-to-world poses (OpenCV convention) of n frames."""
    from test_torch_pose_priors import _rot

    rng = np.random.default_rng(21)
    c2w = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        c2w[i, :3, :3] = _rot(rng.normal(0, 0.3, 3))
        c2w[i, :3, 3] = rng.normal(0, 2, 3)
    return c2w


def check_prior_job(tmp_path, calls, res, n_frames):
    """Both packages completed the same component list, imported the same
    normalised priors and intrinsics, handed the same frames to the
    triangulation and trained on its scene; the delivered model and .spz are
    byte-equal."""
    got, want = res["port"], res["ref"]
    assert got.status == want.status == "Complete"
    assert list(got.timings) == list(want.timings)
    assert {"Process-Pose-Priors", "Image-Undistorter", "SfM"} <= set(got.timings)
    assert got.metrics == want.metrics and got.metrics["num_registered"] == n_frames
    p_got, p_want = calls["port"]["priors"], calls["ref"]["priors"]
    np.testing.assert_array_equal(p_got["c2ws"], p_want["c2ws"])
    assert p_got["intrin"] == p_want["intrin"]
    assert p_got["kw"] == {"device": torch.device("cpu")} and not p_want["kw"]
    assert p_got["images"].shape == (n_frames, H, W, 3)
    np.testing.assert_allclose(p_got["images"], p_want["images"], atol=1e-5, rtol=0)
    assert "sfm" not in calls["port"] and "train" in calls["port"]
    for sub in [os.path.join("colmap", "sparse", "0", f) for f in SPARSE] + [
            os.path.join("colmap", "transforms.json"), os.path.join("exports", "splat.spz")]:
        assert (tmp_path / "port" / sub).read_bytes() == (tmp_path / "ref" / sub).read_bytes(), \
            sub
    return p_got


def test_pose_prior_transforms_json_job_matches_reference(tmp_path, prior_fakes):
    """A NeRFCapture-style zip (frames + transforms.json of ARKit world-to-
    camera matrices, for 11 of the 12 frames) -> the frames with a prior
    are kept, the priors normalised, blind SfM skipped."""
    from tpu_splat_torch.sfm.pose_priors import convert_pose, normalize_poses

    calls, _ = prior_fakes
    zip_path = seeded_zip(str(tmp_path / "capture.zip"))
    c2w = prior_poses(N)
    T = np.diag([1.0, -1.0, -1.0, 1.0])
    frames = [{"file_path": f"images/frame_{i:03d}.png",
               "transform_matrix": (T @ np.linalg.inv(c2w[i]) @ T).tolist()}
              for i in range(N) if i != 4]
    with zipfile.ZipFile(zip_path, "a") as zf:
        zf.writestr("capture/transforms.json", json.dumps(
            {"fl_x": 50.0, "fl_y": 52.0, "cx": 33.0, "cy": 23.5, "w": W, "h": H,
             "frames": frames}))
    res = run_both(tmp_path, {
        "imageProcessing": {"filterBlurryImages": False}, "training": {"maxSteps": 7},
        "sfm": {"posePriors": {"usePosePriorTransformJson": {
            "enable": True, "sourceCoordinateName": "arkit", "poseIsWorldToCam": True}}}},
        zip_path)
    prior = check_prior_job(tmp_path, calls, res, N - 1)
    assert prior["intrin"] == (50.0, 52.0, 33.0, 23.5)
    keep = np.arange(N) != 4
    np.testing.assert_allclose(prior["c2ws"], normalize_poses(c2w[keep])[0], atol=1e-12, rtol=0)
    assert np.allclose(convert_pose(np.asarray(frames[0]["transform_matrix"]), "arkit", True),
                       c2w[0])


def test_pose_prior_colmap_model_job_matches_reference(tmp_path, prior_fakes):
    """A zip carrying a COLMAP text model (sparse/0) whose SIMPLE_RADIAL
    camera has a k1 -> poses read from the model, the frames undistorted on
    the device before the fixed-pose triangulation."""
    from tpu_splat_torch.sfm.colmap_io import write_colmap_model

    calls, _ = prior_fakes
    zip_path = seeded_zip(str(tmp_path / "capture.zip"))
    c2w = prior_poses(N).astype(np.float32)
    cams = ttypes.Cameras(camtoworlds=c2w, fx=np.full(N, 55.0), fy=np.full(N, 55.0),
                          cx=np.full(N, 32.0), cy=np.full(N, 24.0),
                          distortion=np.zeros((N, 4)), width=W, height=H)
    scene = ttypes.SfMScene(cameras=cams, points=np.zeros((0, 3)),
                            point_colors=np.zeros((0, 3)), point_errors=np.zeros(0),
                            track_counts=np.zeros(0, np.int32), registered=np.ones(N, bool))
    model = tmp_path / "model"
    write_colmap_model(scene, str(model), image_names=[f"frame_{i:03d}.png" for i in range(N)])
    (model / "cameras.txt").write_text(f"1 SIMPLE_RADIAL {W} {H} 55.0 32.0 24.0 {K1}\n")
    with zipfile.ZipFile(zip_path, "a") as zf:
        for name in ("cameras.txt", "images.txt", "points3D.txt"):
            zf.write(str(model / name), f"sparse/0/{name}")
    res = run_both(tmp_path, {
        "imageProcessing": {"filterBlurryImages": False}, "training": {"maxSteps": 7},
        "sfm": {"posePriors": {"usePosePriorColmapModelFiles": True}}}, zip_path)
    prior = check_prior_job(tmp_path, calls, res, N)
    assert prior["intrin"] == (55.0, 55.0, 32.0, 24.0)
    np.testing.assert_allclose(prior["c2ws"][:, :3, :3], c2w[:, :3, :3], atol=1e-5, rtol=0)
    import cv2

    with zipfile.ZipFile(zip_path) as zf:  # the frames as the job read them
        raw = np.stack([cv2.imdecode(np.frombuffer(zf.read(f"capture/frame_{i:03d}.png"),
                                                   np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
                        for i in range(N)]).astype(np.float32) / 255.0
    diff = np.abs(prior["images"] - raw)
    assert diff.max() > 0.05 and diff[:, 22:26, 30:34].max() < 0.02  # undistorted, not the centre


def seeded_videos(directory, lengths=(6, 5), w=W, h=H):
    """Two mp4v videos of seeded smooth 64x48 frames, as a multi-video
    property scan uploads them."""
    import cv2

    rng = np.random.default_rng(14)
    directory.mkdir(exist_ok=True)
    paths = []
    for v, n in enumerate(lengths):
        paths.append(str(directory / f"scan_{v}.mp4"))
        vw = cv2.VideoWriter(paths[-1], cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (w, h))
        assert vw.isOpened()
        for _ in range(n):
            img = cv2.resize(rng.uniform(0, 255, (h // 4, w // 4, 3)).astype(np.float32),
                             (w, h), interpolation=cv2.INTER_CUBIC)
            vw.write(np.clip(img, 0, 255).astype(np.uint8))
        vw.release()
    return paths


@pytest.mark.parametrize("form", ["list", "directory"])
def test_multi_video_ingest_matches_reference(tmp_path, form):
    """A comma-separated list of videos, or a directory of several, is
    decoded into one image set, video after video, in both packages."""
    paths = seeded_videos(tmp_path / "videos")
    path = ",".join(paths) if form == "list" else str(tmp_path / "videos")
    out = {}
    for pkg, comp, runner, config in (("ref", jcomp, jrunner, jconfig),
                                      ("port", tcomp, trunner, tconfig)):
        ctx = comp.PipelineContext(cfg=config.job_config_from_json({"inputPath": path}),
                                   out_dir=str(tmp_path / pkg))
        runner._resolve_input(ctx)
        runner._media_to_images(ctx)
        out[pkg] = ctx
    got, want = out["port"], out["ref"]
    assert got["input_kind"] == want["input_kind"] == "multi_video"
    assert got["input_path"] == want["input_path"] == paths
    assert got["segments"] == want["segments"] == [6, 5]
    assert got["images"].shape == (11, H, W, 3) and got["images"].dtype == want["images"].dtype
    np.testing.assert_array_equal(got["images"], want["images"])


@pytest.mark.parametrize("case, code", [("not-a-video", 705), ("missing-video", 710)])
def test_multi_video_input_errors_match_reference(tmp_path, case, code):
    """A list with a non-video (705) or a missing video (710) is refused at
    Resolve-Input with the reference's code, message and job record."""
    import cv2

    paths = seeded_videos(tmp_path / "videos")
    other = str(tmp_path / ("frame.png" if case == "not-a-video" else "gone.mp4"))
    if case == "not-a-video":
        cv2.imwrite(other, np.zeros((H, W, 3), np.uint8))
    errors = {}
    for pkg, config, runner, err in (("ref", jconfig, jrunner, JPipelineError),
                                     ("port", tconfig, trunner, TPipelineError)):
        cfg = config.job_config_from_json({"uuid": case, "inputPath": f"{paths[0]},{other}",
                                           "outputPath": str(tmp_path / pkg)})
        kw = {"device": "cpu"} if pkg == "port" else {}
        with pytest.raises(err) as e:
            runner.run_job(cfg, **kw)
        store = json.loads((tmp_path / pkg / "jobs" / f"{case}.json").read_text())
        errors[pkg] = (e.value.code, str(e.value), store["status"], store["code"])
    assert errors["port"] == errors["ref"] and errors["port"][0] == code


def test_multi_video_job_matches_reference(tmp_path, fakes):
    """A multi-video job completes in both packages through the same stages,
    and SfM gets the same merged frames."""
    calls, state = fakes
    state["n_reg"] = 10  # of the 11 frames of both videos
    paths = seeded_videos(tmp_path / "videos")
    res = run_both(tmp_path, {"training": {"maxSteps": 7}}, ",".join(paths))
    got, want = res["port"], res["ref"]
    assert got.status == want.status == "Complete"
    assert list(got.timings) == list(want.timings) == [
        "Resolve-Input", "Media-To-Images", "Filter-Blurry-Images", "SfM", "Quality-Gate",
        "Train-Stage1", "Export-Splat", "Rotate-Mirror-SPZ-Export", "Artifact-Export"]
    assert got.metrics == want.metrics and got.metrics["num_images"] == 11
    assert got.artifacts.keys() == want.artifacts.keys()
    np.testing.assert_array_equal(calls["port"]["sfm"]["images"], calls["ref"]["sfm"]["images"])


def test_both_options_fail_in_the_reference_and_are_refused_by_the_port(
        tmp_path, fakes, monkeypatch, capsys):
    """removeBackground with sphericalCamera: the reference's job keeps one
    mask per equirectangular frame through the cube-face expansion and fails
    after it; the port refuses the job before any stage (705), and its
    generator refuses the flag pair."""
    from tpu_splat.cli import generate_splat as jgen
    from tpu_splat_torch.cli import generate_splat as tgen

    zip_path = seeded_zip(str(tmp_path / "capture.zip"), n=3, w=64, h=32)
    lines = []
    job = jgen.build_job_json(zip_path, str(tmp_path / "ref"), "fast", remove_background=True,
                              spherical=True, job_uuid="both")
    with pytest.raises(JPipelineError):
        jrunner.run_job(jconfig.job_config_from_json(job), log_fn=lines.append)
    expanded = next(i for i, s in enumerate(lines)
                    if s.startswith("[Spherical-To-Perspective] done"))
    assert any(s.startswith("ERROR") for s in lines[expanded:])

    ran = []
    monkeypatch.setattr(trunner, "_resolve_input", ran.append)
    job = tgen.build_job_json(zip_path, str(tmp_path / "port"), "fast", remove_background=True,
                              spherical=True, job_uuid="both")
    with pytest.raises(TPipelineError) as e:
        trunner.run_job(tconfig.job_config_from_json(job), device="cpu")
    assert e.value.code == 705 and ran == []
    assert "removeBackground" in str(e.value) and "sphericalCamera" in str(e.value)
    store = json.loads((tmp_path / "port" / "jobs" / "both.json").read_text())
    assert store["status"] == "Error" and store["code"] == 705

    out = str(tmp_path / "generated")
    with pytest.raises(SystemExit) as e:
        tgen.main([zip_path, "-o", out, "--remove-background", "--spherical", "--job-only"])
    assert e.value.code == 2 and not os.path.exists(out)
    err = capsys.readouterr().err
    assert "--remove-background" in err and "--spherical" in err

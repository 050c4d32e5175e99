"""Package-level checks of the PyTorch/CUDA port: it never imports JAX or the
JAX package, its entry points refuse to fall back to the CPU silently, and
convert.py round-trips the training state."""

import ast
import os
from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_splat.gs import optim as joptim
from tpu_splat_torch import convert
from tpu_splat_torch.core.types import Cameras, GaussianCloud, SfMScene
from tpu_splat_torch.gs import params as tparams
from tpu_splat_torch.gs import pipeline as tpipe
from tpu_splat_torch.gs import rasterize as tras
from tpu_splat_torch.gs import render as trend
from tpu_splat_torch.gs import trainer as ttrainer
from tpu_splat_torch.sfm.features import FeatureConfig, extract_features_batch
from tpu_splat_torch.core.config import JobConfig
from tpu_splat_torch.core.errors import PipelineError
from tpu_splat_torch.pipeline.runner import run_job
from tpu_splat_torch.sfm.mapper import run_sfm
from tpu_splat_torch.sfm.undistort import undistort_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "tpu_splat")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tpu_splat_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_and_no_reference_package():
    bad = []
    files = _port_files()
    # the SfM slice's modules, the default job's, matting's and spherical's
    # are scanned too
    scanned = {os.path.relpath(f, REPO) for f in files}
    new = {"sfm/" + m for m in ("geometry", "features", "matching", "ba", "intrinsics",
                                "mapper", "undistort", "colmap_io", "colmap_db")}
    new |= {"core/config", "core/errors", "ingest/video", "ingest/blur", "export/transforms",
            "pipeline/component", "pipeline/runner", "pipeline/sink", "cli/main"}
    new |= {"matting/matnet", "matting/u2net", "matting/remove", "matting/synthdata",
            "spherical/projections", "spherical/pipeline", "cli/generate_splat"}
    new |= {"sfm/pose_priors", "sfm/global_mapper", "export/measurement", "export/floorplan",
            "export/objects", "export/mesh", "export/native", "core/meshrender"}
    new |= {"mesh/distributed", "mesh/trainer", "mesh/launch", "web/server", "web/splat_format"}
    new |= {"matting/train"}
    assert {os.path.join("tpu_splat_torch", *m.split("/")) + ".py" for m in new} <= scanned
    assert len(files) > 40
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [(os.path.relpath(path, REPO), m) for m in mods
                    if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_raise_without_gpu_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without one")
    n, w, h = 8, 32, 32
    z = torch.zeros
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tras.rasterize(z(n, 2), z(n, 3), z(n, 3), z(n), z(n), z(n), w, h)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trend.render_view(z(n, 3), z(n, 3), z(n, 4), z(n), z(n, 3), z(n, 0, 3), torch.eye(4),
                          10.0, 10.0, 16.0, 16.0, w, h)
    pts = np.random.default_rng(0).uniform(-1, 1, (n, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tparams.init_params_from_points(pts, np.zeros((n, 3)), capacity=16)
    p = tparams.init_params_from_points(pts, np.zeros((n, 3)), capacity=16, device="cpu")
    imgs = np.zeros((2, h, w, 3), np.float32)
    vms = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    intr = np.tile(np.array([[10.0, 10.0, 16.0, 16.0]], np.float32), (2, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.Trainer(p, imgs, vms, intr, 1.0, ttrainer.TrainConfig())
    cams = Cameras(vms, intr[:, 0], intr[:, 1], intr[:, 2], intr[:, 3],
                   np.zeros((2, 4), np.float32), w, h)
    scene = SfMScene(cams, pts, np.zeros((n, 3)), np.zeros(n), np.ones(n), np.ones(2, bool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.train_splat(scene, imgs, max_steps=1)
    fcfg = FeatureConfig(max_features=16, num_octaves=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_features_batch(np.zeros((1, h, w), np.float32), fcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sfm(imgs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sfm(imgs, export_database="database.db")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        undistort_batch(imgs, 10.0, 10.0, 16.0, 16.0, -0.1)
    from tpu_splat_torch.export.measurement import estimate_scale_from_tripod
    from tpu_splat_torch.export.mesh import extract_mesh
    from tpu_splat_torch.sfm.global_mapper import rotation_averaging, run_global_sfm
    from tpu_splat_torch.sfm.pose_priors import sfm_with_pose_priors

    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_global_sfm(imgs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sfm_with_pose_priors(imgs, np.tile(np.eye(4), (2, 1, 1)), 10.0, 10.0, 16.0, 16.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rotation_averaging(2, [(0, 1)], [np.eye(3)], [1.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        estimate_scale_from_tripod(np.zeros((20, 3)), np.tile(np.eye(4), (2, 1, 1)), 1.5)
    cloud = GaussianCloud(pts, np.full((n, 3), -3.0), np.tile([1.0, 0, 0, 0], (n, 1)),
                                np.ones(n), np.zeros((n, 3)), np.zeros((n, 0, 3)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_mesh(cloud, resolution=8)
    job = JobConfig(input_path=str(tmp_path / "capture.zip"), output_path=str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_job(job)
    # asked for, the CPU works
    out = tras.rasterize(z(n, 2), z(n, 3), z(n, 3), z(n), z(n), z(n), w, h, device="cpu")
    assert out.color.shape == (h, w, 3)
    feats = extract_features_batch(np.zeros((1, h, w), np.float32), fcfg, device="cpu")
    assert feats.descriptor.shape == (1, 16, 128) and not feats.valid.any()
    assert undistort_batch(imgs, 10.0, 10.0, 16.0, 16.0, -0.1, device="cpu").shape == imgs.shape
    with pytest.raises(PipelineError, match="710"):  # past the device check, to the input
        run_job(job, device="cpu")


def test_multi_card_launcher_and_served_jobs_default_to_cuda(tmp_path, monkeypatch, capsys):
    """train_splat(distributed=True) and a rank's mesh device default to CUDA
    and raise without a GPU; so does the job subprocess that `serve` starts,
    unless the server was given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without one")
    from tpu_splat_torch.cli.main import main as cli_main
    from tpu_splat_torch.mesh.distributed import rank_device
    from tpu_splat_torch.web import server as tserver

    n, w, h = 8, 32, 32
    pts = np.random.default_rng(0).uniform(-1, 1, (n, 3)).astype(np.float32)
    imgs = np.zeros((2, h, w, 3), np.float32)
    vms = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    intr = np.tile(np.array([[10.0, 10.0, 16.0, 16.0]], np.float32), (2, 1))
    cams = Cameras(vms, intr[:, 0], intr[:, 1], intr[:, 2], intr[:, 3],
                   np.zeros((2, 4), np.float32), w, h)
    scene = SfMScene(cams, pts, np.zeros((n, 3)), np.zeros(n), np.ones(n), np.ones(2, bool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.train_splat(scene, imgs, max_steps=1, distributed=True, world_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rank_device()
    assert rank_device("cpu") == torch.device("cpu")

    commands = []
    monkeypatch.setattr(tserver.subprocess, "Popen",
                        lambda cmd, **kw: commands.append(cmd) or SimpleNamespace(
                            poll=lambda: 0))
    for device in (None, "cpu"):
        state = tserver._State(str(tmp_path / "store"), device)
        code, _ = state.submit({"uuid": f"job-{device}", "inputPath": str(tmp_path / "none.zip")})
        assert code == 202
    no_device, cpu = commands
    assert no_device[1:4] == ["-m", "tpu_splat_torch.cli.main", "run"] and len(no_device) == 5
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(no_device[3:])
    assert cpu[5:] == ["--device", "cpu"]
    assert cli_main(cpu[3:]) == 1  # past the device check: the capture does not exist
    assert "FAILED" in capsys.readouterr().err


def test_matnet_training_raises_without_gpu_unless_cpu_is_asked_for(tmp_path, monkeypatch):
    """train_matnet and `python -m tpu_splat_torch.matting.train` default to
    CUDA and raise without a GPU; with the CPU asked for they train."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without one")
    import subprocess
    import sys

    from tpu_splat_torch.matting import train as mtrain

    out = str(tmp_path / "matnet.npz")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mtrain.train_matnet(steps=1, batch=1, out=out)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mtrain.evaluate(out)
    proc = subprocess.run([sys.executable, "-m", "tpu_splat_torch.matting.train", "--steps", "1",
                           "--batch", "1", "--out", out], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    assert not os.path.exists(out)
    # asked for, the CPU trains (the CLI's held-out evaluation is recorded, not run)
    seen = []
    monkeypatch.setattr(mtrain, "evaluate", lambda path, dev, log: seen.append((path, dev)))
    assert mtrain.main(["--steps", "1", "--batch", "1", "--out", out, "--device", "cpu"]) == 0
    assert seen == [(out, torch.device("cpu"))]
    with np.load(out) as z:
        assert z["head.w"].dtype == np.float16 and z["head.w"].shape == (1, 1, 16, 1)


def test_core_exports_match_the_reference():
    import tpu_splat.core as jcore
    import tpu_splat_torch.core as tcore

    assert tcore.__all__ == jcore.__all__
    assert [(m.name, m.value) for m in tcore.CameraModel] == \
        [(m.name, m.value) for m in jcore.CameraModel]


def test_convert_round_trips_params_and_adam_state():
    rng = np.random.default_rng(0)
    n = 16
    p = {"means": rng.normal(size=(n, 3)).astype(np.float32),
         "shN": rng.normal(size=(n, 15, 3)).astype(np.float32),
         "alive": rng.uniform(size=n) < 0.5}
    st = joptim.adam_init({k: jnp.asarray(v) for k, v in p.items()})
    st = st._replace(mu={k: (v + 0.3).astype(v.dtype) for k, v in st.mu.items()},
                     count=jnp.asarray(7, jnp.int32))
    tp = convert.params_to_torch(p, "cpu")
    assert tp["alive"].dtype == torch.bool and tp["means"].dtype == torch.float32
    back = convert.params_to_numpy(tp)
    for k in p:
        assert np.array_equal(back[k], p[k])
    ts = convert.adam_to_torch({k: np.asarray(v) for k, v in st.mu.items()},
                               {k: np.asarray(v) for k, v in st.nu.items()}, st.count, "cpu")
    assert ts.mu["shN"].dtype == torch.bfloat16 and int(ts.count) == 7
    mu, nu, count = convert.adam_to_numpy(ts)
    for k in st.mu:
        assert np.array_equal(mu[k], np.asarray(st.mu[k]).astype(np.float32))
        assert np.array_equal(nu[k], np.asarray(st.nu[k]))
    assert int(count) == 7


def test_kernel_wrappers_refuse_cpu_tensors_and_huge_renders():
    """The CUDA wrappers validate before they load anything: a CPU tensor is
    refused (the autograd.Function sends those to the plain versions), and a
    render past the 16-bit tile key is refused as in the reference."""
    from tpu_splat_torch.core.errors import PipelineError
    from tpu_splat_torch.gs import cuda_raster as cr

    packed = torch.zeros((cr.C_PACK, 2, cr.CHUNK))
    counts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cr.composite_fwd_cuda(packed, counts, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cr.composite_bwd_cuda(packed, counts, torch.zeros((2, 8, cr.P)),
                              torch.zeros((2, cr.P)), torch.zeros((2, cr.P)), 2)
    with pytest.raises(PipelineError, match="765"):
        tras.tile_gaussians(torch.zeros((4, 2)), torch.ones(4), torch.ones(4),
                            16 * 256, 16 * 256, 16, 128)

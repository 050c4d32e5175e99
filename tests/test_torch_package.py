"""Package-level checks of the PyTorch/CUDA port: it never imports JAX or the
JAX package, its entry points refuse to fall back to the CPU silently, and
convert.py round-trips the training state."""

import ast
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpu_splat.gs import optim as joptim
from tpu_splat_torch import convert
from tpu_splat_torch.core.types import Cameras, SfMScene
from tpu_splat_torch.gs import params as tparams
from tpu_splat_torch.gs import pipeline as tpipe
from tpu_splat_torch.gs import rasterize as tras
from tpu_splat_torch.gs import render as trend
from tpu_splat_torch.gs import trainer as ttrainer

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
    assert len(files) > 15
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


def test_entry_points_raise_without_gpu_unless_cpu_is_asked_for():
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
    # asked for, the CPU works
    out = tras.rasterize(z(n, 2), z(n, 3), z(n, 3), z(n), z(n), z(n), w, h, device="cpu")
    assert out.color.shape == (h, w, 3)


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
        cr.composite_bwd_cuda(packed, torch.zeros((2, 8, cr.P)),
                              torch.zeros((2, cr.P)), torch.zeros((2, cr.P)), 2)
    with pytest.raises(PipelineError, match="765"):
        tras.tile_gaussians(torch.zeros((4, 2)), torch.ones(4), torch.ones(4),
                            16 * 256, 16 * 256, 16, 128)

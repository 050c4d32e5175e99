"""The port's CUDA compositing kernels against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc (the kernels have no interpret mode), so every
test here carries the `cuda` marker and skips on a machine without a card.
Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from tpu_splat_torch.gs import cuda_raster as cr
from tpu_splat_torch.testing import RAGGED_COUNTS, build_packed

TX, TY = 4, 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_kernels_match_plain_versions(cuda_device, ragged):
    """Two forward launches bit-identical, forward and tstart max abs 2e-5
    with the same chunks reached, counts-bounded sweep bit-identical,
    backward max|d| / max|g| 5e-5 fed by the plain and by the kernel's own
    tstart, two backward launches bit-identical and exactly 0 past each
    tile's count, and the autograd.Function launches both kernels. The
    ragged case puts tiles on the backward's segment and chunk edges
    (RAGGED_COUNTS)."""
    rng = np.random.default_rng(1)
    packed_np, counts_np = build_packed(rng, TX * TY, 2 * cr.CHUNK, TX,
                                        counts=RAGGED_COUNTS if ragged else None)
    packed = torch.from_numpy(packed_np).to(cuda_device)
    counts = torch.from_numpy(counts_np).to(cuda_device)
    out_k, ts_k = cr.composite_fwd_cuda(packed, counts, TX)
    out_again, ts_again = cr.composite_fwd_cuda(packed, counts, TX)
    assert torch.equal(out_k, out_again) and torch.equal(ts_k, ts_again)
    out_p, ts_p = cr.composite_tiles_plain(packed, counts, TX, TY)
    assert float((out_k[:, :5] - out_p[:, :5]).abs().max()) <= 2e-5
    assert float((ts_k - ts_p).abs().max()) <= 2e-5
    reached = [ts.reshape(TX * TY, -1, cr.P).amax(dim=2) > 0 for ts in (ts_k, ts_p)]
    assert torch.equal(*reached)
    out_full, _ = cr.composite_fwd_cuda(packed, torch.full_like(counts, packed.shape[2]), TX)
    assert torch.equal(out_k[:, :5], out_full[:, :5])
    gout = torch.from_numpy(rng.standard_normal(out_p.shape).astype(np.float32)).to(cuda_device)
    t_final = (1.0 - out_p[:, 3]).contiguous()
    g_k = cr.composite_bwd_cuda(packed, counts, gout, ts_p, t_final, TX)
    g_p = cr.composite_tiles_bwd_plain(packed, gout, ts_p, t_final, TX)
    g_scale = float(g_p.abs().max())
    assert float((g_k - g_p).abs().max()) / g_scale <= 5e-5
    g_kk = cr.composite_bwd_cuda(packed, counts, gout, ts_k, (1.0 - out_k[:, 3]).contiguous(), TX)
    assert float((g_kk - g_p).abs().max()) / g_scale <= 5e-5
    assert torch.equal(g_k, cr.composite_bwd_cuda(packed, counts, gout, ts_p, t_final, TX))
    past = torch.arange(packed.shape[2], device=cuda_device)[None, :] >= counts[:, None].long()
    assert bool((g_k[:, past] == 0).all())

    before = dict(cr.LAUNCHES)
    p = packed.clone().requires_grad_(True)
    (cr.composite_tiles(p, counts, TX, TY) * gout).sum().backward()
    assert cr.LAUNCHES["composite_fwd"] == before["composite_fwd"] + 1
    assert cr.LAUNCHES["composite_bwd"] == before["composite_bwd"] + 1
    assert float((p.grad - g_p).abs().max()) / g_scale <= 5e-5


def saturating_packed(rng, k, count):
    """build_packed's fixture at K=k with tile 2 holding `count` wide, nearly
    opaque gaussians that cover every pixel: its tile-wide exit fires after
    chunk 0 although its count reaches further chunks."""
    counts = [4 if t == 1 else count if t == 2 else k for t in range(TX * TY)]
    packed, counts = build_packed(rng, TX * TY, k, TX, counts=counts)
    packed[2:5, 2, :count] = np.array([1 / 900, 0.0, 1 / 900], np.float32)[:, None]
    packed[8, 2, :count] = 0.99
    return packed, counts


@pytest.mark.cuda
@pytest.mark.parametrize("count", [129, 300, 512])
def test_forward_exit_after_first_of_several_chunks(cuda_device, count):
    """A tile whose exit fires after chunk 0 while its count reaches chunks
    1-3 (K=512): the kernel reaches the same chunks as the plain version,
    agrees with it to 2e-5, and two launches give the same bits."""
    packed_np, counts_np = saturating_packed(np.random.default_rng(3), 4 * cr.CHUNK, count)
    packed = torch.from_numpy(packed_np).to(cuda_device)
    counts = torch.from_numpy(counts_np).to(cuda_device)
    out_k, ts_k = cr.composite_fwd_cuda(packed, counts, TX)
    out_p, ts_p = cr.composite_tiles_plain(packed, counts, TX, TY)
    reached = [ts.reshape(TX * TY, -1, cr.P).amax(dim=2) > 0 for ts in (ts_k, ts_p)]
    assert reached[1][2].tolist() == [True, False, False, False]
    assert torch.equal(*reached)
    assert float((out_k[:, :5] - out_p[:, :5]).abs().max()) <= 2e-5
    assert float((ts_k - ts_p).abs().max()) <= 2e-5
    out_again, ts_again = cr.composite_fwd_cuda(packed, counts, TX)
    assert torch.equal(out_k, out_again) and torch.equal(ts_k, ts_again)


@pytest.mark.cuda
def test_kernels_launch_on_the_tensors_card(cuda_device):
    """With the inputs on the last card and cuda:0 current, both kernels run
    on the inputs' card (a multi-card rank's case) and agree with the plain
    versions. Needs two cards; skips with one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(2)
    packed_np, counts_np = build_packed(rng, TX * TY, 2 * cr.CHUNK, TX)
    packed = torch.from_numpy(packed_np).to(last)
    counts = torch.from_numpy(counts_np).to(last)
    out_k, ts_k = cr.composite_fwd_cuda(packed, counts, TX)
    out_p, ts_p = cr.composite_tiles_plain(packed, counts, TX, TY)
    assert out_k.device == last and torch.cuda.current_device() == 0
    assert float((out_k[:, :5] - out_p[:, :5]).abs().max()) <= 2e-5
    assert float((ts_k - ts_p).abs().max()) <= 2e-5
    gout = torch.from_numpy(rng.standard_normal(out_p.shape).astype(np.float32)).to(last)
    t_final = (1.0 - out_p[:, 3]).contiguous()
    g_k = cr.composite_bwd_cuda(packed, counts, gout, ts_p, t_final, TX)
    g_p = cr.composite_tiles_bwd_plain(packed, gout, ts_p, t_final, TX)
    torch.cuda.synchronize(last)
    assert g_k.device == last
    assert float((g_k - g_p).abs().max()) / float(g_p.abs().max()) <= 5e-5


LRS = {"means": 1.6e-4, "scales": 5e-3, "quats": 1e-3, "opacities": 5e-2, "sh0": 2.5e-3,
       "shN": 1.25e-4}


def adam_case(rng, n, sh_rest, device, pad=0):
    """Leaves of n rows (shN with sh_rest coefficient sets), their gradients
    and an Adam state three steps in, with nonzero moments (shN's first in
    bf16). With pad, every tensor is the last n rows of one with `pad` more,
    so that none starts on a 16-byte boundary."""
    from tpu_splat_torch.gs.optim import AdamState

    widths = {"means": (3,), "scales": (3,), "quats": (4,), "opacities": (),
              "sh0": (3,), "shN": (sh_rest, 3)}

    def draw(shape, scale=1.0, dtype=torch.float32, positive=False):
        v = rng.standard_normal((n + pad,) + shape).astype(np.float32) * scale
        return torch.from_numpy(np.abs(v) if positive else v).to(device, dtype)[pad:]

    params = {k: draw(w) for k, w in widths.items()}
    grads = {k: draw(w, 0.1) for k, w in widths.items()}
    mu = {k: draw(w, 0.01, torch.bfloat16 if k == "shN" else torch.float32)
          for k, w in widths.items()}
    nu = {k: draw(w, 1e-3, positive=True) for k, w in widths.items()}
    alive = torch.from_numpy(rng.uniform(size=n + pad) < 0.7).to(device)[pad:]
    visible = torch.from_numpy(rng.uniform(size=n + pad) < 0.5).to(device)[pad:]
    count = torch.tensor(3, dtype=torch.int32, device=device)
    return params, grads, AdamState(mu, nu, count), alive, visible


def max_rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "visible", "empty_shN", "unaligned"])
def test_adam_kernel_matches_plain_chain(cuda_device, case):
    """Two successive steps of the kernel against adam_update_plain on the
    card, with the alive mask, over 1001 rows (no leaf a multiple of the
    8-element group): parameters and both moments (shN's first in bf16)
    within 1e-6 relative, two launches on one input bit-identical, one launch
    a step, the inputs left as they were. `visible` restricts the update,
    `empty_shN` is a degree-0 cloud, and `unaligned` takes row slices that
    start off a 16-byte boundary, as a rank's shard of the leaves may."""
    from tpu_splat_torch.gs.optim import adam_update, adam_update_cuda, adam_update_plain

    rng = np.random.default_rng(4)
    params, grads, state, alive, visible = adam_case(
        rng, 1001, 0 if case == "empty_shN" else 15, cuda_device,
        pad=1 if case == "unaligned" else 0)
    vis = visible if case == "visible" else None
    kp, ks, pp, ps = params, state, params, state
    for step in range(2):
        g = grads if step == 0 else {k: -0.5 * v for k, v in grads.items()}
        before = {k: v.clone() for k, v in kp.items()}
        launches = cr.LAUNCHES["adam"]
        kp1, ks1 = adam_update(kp, g, ks, LRS, visible=vis, grad_mask=alive)
        again, again_s = adam_update_cuda(kp, g, ks, LRS, visible=vis, grad_mask=alive)
        assert cr.LAUNCHES["adam"] == launches + 2
        pp, ps = adam_update_plain(pp, g, ps, LRS, visible=vis, grad_mask=alive)
        for k in LRS:
            assert torch.equal(kp[k], before[k]), k
            assert torch.equal(kp1[k], again[k]) and torch.equal(ks1.nu[k], again_s.nu[k]), k
            assert torch.equal(ks1.mu[k], again_s.mu[k]), k
            assert ks1.mu[k].dtype == ps.mu[k].dtype, k
            if kp1[k].numel():
                assert max_rel(kp1[k], pp[k]) <= 1e-6, k
                assert max_rel(ks1.mu[k], ps.mu[k]) <= 1e-6, k
                assert max_rel(ks1.nu[k], ps.nu[k]) <= 1e-6, k
        assert int(ks1.count) == int(ps.count) == 4 + step
        kp, ks = kp1, ks1
    if vis is not None:
        hidden = ~visible
        for k in LRS:
            assert torch.equal(kp[k][hidden], params[k][hidden]), k
            assert torch.equal(ks.mu[k][hidden], state.mu[k][hidden]), k


@pytest.mark.cuda
def test_adam_kernel_refuses_what_it_does_not_take(cuda_device):
    """A non-contiguous or wrong-dtype gradient, a moment of another type, a
    learning rate on the device and a mask of another length raise before
    any launch."""
    from tpu_splat_torch.gs.optim import adam_update_cuda

    params, grads, state, alive, _ = adam_case(np.random.default_rng(5), 64, 15, cuda_device)
    launches = cr.LAUNCHES["adam"]
    bad = [
        ({**grads, "means": grads["means"].t().contiguous().t()}, state, LRS, alive),
        ({**grads, "scales": grads["scales"].double()}, state, LRS, alive),
        (grads, state._replace(mu={**state.mu, "quats": state.mu["quats"].half()}), LRS,
         alive),
        (grads, state, {**LRS, "sh0": torch.tensor(1e-3, device=cuda_device)}, alive),
        (grads, state, LRS, alive[:-1]),
    ]
    for g, st, lrs, mask in bad:
        with pytest.raises(ValueError):
            adam_update_cuda(params, g, st, lrs, grad_mask=mask)
    assert cr.LAUNCHES["adam"] == launches

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

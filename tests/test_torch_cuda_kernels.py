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
    """Forward and tstart max abs 2e-5 with the same chunks reached,
    counts-bounded sweep bit-identical, backward max|d| / max|g| 5e-5 fed by
    the plain and by the kernel's own tstart, two backward launches
    bit-identical and exactly 0 past each tile's count, and the
    autograd.Function launches both kernels. The ragged case puts tiles on
    the backward's segment and chunk edges (RAGGED_COUNTS)."""
    rng = np.random.default_rng(1)
    packed_np, counts_np = build_packed(rng, TX * TY, 2 * cr.CHUNK, TX,
                                        counts=RAGGED_COUNTS if ragged else None)
    packed = torch.from_numpy(packed_np).to(cuda_device)
    counts = torch.from_numpy(counts_np).to(cuda_device)
    out_k, ts_k = cr.composite_fwd_cuda(packed, counts, TX)
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

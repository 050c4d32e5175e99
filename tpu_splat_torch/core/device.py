"""Device selection shared by the port's public entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`cuda` unless the caller asks for another device; raises when CUDA is
    asked for (explicitly or by default) and no GPU is present, so a run never
    carries on quietly on the CPU.

    On CUDA the port computes in full f32, as the reference does: TF32 is
    switched off for matmuls and cuDNN (it keeps ~3 decimal digits, and the
    SSIM blur is a matmul), process-wide, here where the device is chosen."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def as_tensor(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """Move a tensor to `device` (keeping its autograd history) or build one
    from array-like data."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(x, dtype=dtype, device=device)

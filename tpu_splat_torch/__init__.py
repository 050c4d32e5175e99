"""PyTorch/CUDA port of tpu_splat's 3DGS training path.

The JAX package `tpu_splat` stays the reference; this package mirrors its module
layout (`tpu_splat_torch/gs/rasterize.py` <-> `tpu_splat/gs/rasterize.py`) and
never imports it. Public entry points run on `cuda` unless the caller passes
`device="cpu"`, and raise when no GPU is present and the CPU was not asked for.
"""

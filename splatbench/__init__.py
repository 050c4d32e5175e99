"""Benchmark of the PyTorch/CUDA port's 3DGS training on one H100."""

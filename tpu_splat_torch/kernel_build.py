"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file has a plain C interface and is compiled with `nvcc` for
Hopper (`sm_90a`) into a shared library, loaded with ctypes. The build happens
at first use, from the sources in the package only, into `build/tpu_splat_torch/`
beside the package (ignored by git); a library is named by the hash of its
source, so an edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Tuple

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "tpu_splat_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def build(name: str) -> Tuple[str, str]:
    """Compile csrc/<name>.cu unless a library for this exact source exists.
    Returns (library path, compiler log; empty when the library was reused)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """Load the library for csrc/<name>.cu, building it first if needed."""
    return ctypes.CDLL(build(name)[0])

"""Bindings to the native C++ SPZ codec (native/spz; the port of
tpu_splat/export/native.py).

Provides the `splat_converter` CLI (mirrors the reference tool invoked at
main.py:1532-1548) and the `libspz_converter.so` C ABI (`ConvertSpzToPly`,
plus the `ConvertPlyToSpz` extension) via ctypes. Both are compiled from the
repo's sources with the C++ compiler directly (no cmake) at first use, into
build/tpu_splat_torch/native/ beside the package (ignored by git), in a
directory named by the hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused, as kernel_build.py does for the CUDA
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_REPO_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _REPO_ROOT / "native" / "spz"
BUILD_ROOT = _REPO_ROOT / "build" / "tpu_splat_torch" / "native"
SOURCES = ("spz_codec.h", "spz_codec.cpp", "main.cpp", "c_api.cpp")
CXX_FLAGS = ["-O2", "-std=c++20", "-fPIC", "-fvisibility=hidden"]
# target -> (extra flags, translation units); both link zlib
TARGETS = {
    "splat_converter": ([], ["main.cpp", "spz_codec.cpp"]),
    "libspz_converter.so": (["-shared"], ["c_api.cpp", "spz_codec.cpp"]),
}


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "c++"))
    if not found:
        raise RuntimeError("no C++ compiler found (c++ or $CXX): the native codec needs one")
    return found


def build_dir() -> Path:
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((_NATIVE_DIR / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_native(force: bool = False) -> Path:
    """Build the native codec if needed; returns the build directory, which
    holds `splat_converter` and `libspz_converter.so`."""
    out = build_dir()
    if not force and all((out / t).exists() for t in TARGETS):
        return out
    out.mkdir(parents=True, exist_ok=True)
    cxx = _cxx()
    jobs = []
    for target, (flags, units) in TARGETS.items():
        fd, tmp = tempfile.mkstemp(dir=out, suffix=".tmp")
        os.close(fd)
        cmd = [cxx, *CXX_FLAGS, *flags, "-o", tmp, *(str(_NATIVE_DIR / u) for u in units),
               "-lz"]
        jobs.append((target, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    try:
        for target, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"building {target} failed:\n{log}")
            os.replace(tmp, out / target)
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def splat_converter_path() -> Path:
    return build_native() / "splat_converter"


def run_splat_converter(input_path: str) -> Path:
    """Convert .ply<->.spz with the native CLI; returns the output path."""
    inp = Path(input_path)
    out = inp.with_suffix(".spz" if inp.suffix == ".ply" else ".ply")
    subprocess.run([str(splat_converter_path()), str(inp)], check=True, capture_output=True)
    return out


_lib: Optional[ctypes.CDLL] = None


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib_path = build_native() / "libspz_converter.so"
        _lib = ctypes.CDLL(str(lib_path))
        _lib.ConvertSpzToPly.restype = ctypes.c_bool
        _lib.ConvertSpzToPly.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        _lib.ConvertPlyToSpz.restype = ctypes.c_bool
        _lib.ConvertPlyToSpz.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    return _lib


def convert_spz_to_ply(spz_path: str, ply_path: str) -> bool:
    return bool(_load_lib().ConvertSpzToPly(str(spz_path).encode(), str(ply_path).encode()))


def convert_ply_to_spz(ply_path: str, spz_path: str) -> bool:
    return bool(_load_lib().ConvertPlyToSpz(str(ply_path).encode(), str(spz_path).encode()))

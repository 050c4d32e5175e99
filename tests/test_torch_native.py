"""The port's native codec bindings (tpu_splat_torch/export/native.py) and
the CLI's `convert`, against the port's own codecs, as
tests/test_native_spz.py holds the reference's: the repo's C++ codec
(native/spz), compiled with the C++ compiler
directly into build/tpu_splat_torch/native/, writes a .spz whose packed
payload is byte-equal to core/spz.pack_gaussians on the same cloud, reads
.spz back to .ply, and refuses an unknown extension. Skipped where there is
no C++ compiler or zlib."""

import gzip
import shutil
import subprocess

import numpy as np
import pytest

from tpu_splat_torch.cli import main as tcli
from tpu_splat_torch.core import spz
from tpu_splat_torch.core.ply import load_ply, save_ply
from tpu_splat_torch.core.types import GaussianCloud
from tpu_splat_torch.export import native


def random_cloud(rng, n, sh_degree):
    k = {0: 0, 1: 3, 2: 8, 3: 15}[sh_degree]
    return GaussianCloud(
        means=(rng.normal(size=(n, 3)) * 5).astype(np.float32),
        scales=(rng.normal(size=(n, 3)) * 1.5 - 4).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.normal(size=(n,)).astype(np.float32) * 2,
        sh0=rng.normal(size=(n, 3)).astype(np.float32),
        shN=(rng.normal(size=(n, k, 3)) * 0.3).astype(np.float32))


@pytest.fixture(scope="module")
def build_dir():
    if shutil.which("c++") is None:
        pytest.skip("no C++ compiler")
    try:
        return native.build_native()
    except RuntimeError as e:  # no zlib headers: the compile fails
        pytest.skip(f"the native codec does not build here: {e}")


def test_build_is_keyed_by_the_sources_and_reused(build_dir):
    assert build_dir.parent == native.BUILD_ROOT and build_dir == native.build_dir()
    assert (build_dir / "splat_converter").exists()
    assert (build_dir / "libspz_converter.so").exists()
    mtime = (build_dir / "splat_converter").stat().st_mtime_ns
    assert native.build_native() == build_dir
    assert (build_dir / "splat_converter").stat().st_mtime_ns == mtime


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_cli_convert_ply_to_spz_matches_the_python_writer(tmp_path, build_dir, capsys,
                                                          sh_degree):
    cloud = random_cloud(np.random.default_rng(sh_degree), 333, sh_degree)
    ply = tmp_path / "splat.ply"
    save_ply(cloud, str(ply))
    assert tcli.main(["convert", str(ply)]) == 0
    assert "Converted" in capsys.readouterr().out
    out = tmp_path / "splat.spz"
    assert gzip.decompress(out.read_bytes()) == spz.pack_gaussians(cloud)


def test_spz_to_ply_and_c_abi(tmp_path, build_dir):
    cloud = random_cloud(np.random.default_rng(7), 64, 2)
    spz_path = tmp_path / "a.spz"
    spz.save_spz(cloud, str(spz_path))
    out = native.run_splat_converter(str(spz_path))
    expected = spz.unpack_gaussians(spz.pack_gaussians(cloud))
    back = load_ply(str(out))
    for name in ("means", "scales", "sh0", "shN"):
        np.testing.assert_allclose(getattr(back, name), getattr(expected, name), atol=1e-6)
    np.testing.assert_allclose(back.opacities, expected.opacities, atol=2e-3)
    ply_path = tmp_path / "b.ply"
    assert native.convert_spz_to_ply(str(spz_path), str(ply_path))
    np.testing.assert_allclose(load_ply(str(ply_path)).means, expected.means, atol=1e-6)
    assert native.convert_ply_to_spz(str(ply_path), str(tmp_path / "c.spz"))
    assert gzip.decompress((tmp_path / "c.spz").read_bytes()) == \
        spz.pack_gaussians(load_ply(str(ply_path)))


def test_cli_rejects_unknown_extension(tmp_path, build_dir):
    p = tmp_path / "x.txt"
    p.write_text("hi")
    res = subprocess.run([str(native.splat_converter_path()), str(p)], capture_output=True,
                         text=True)
    assert res.returncode != 0 and "Unsupported" in res.stderr

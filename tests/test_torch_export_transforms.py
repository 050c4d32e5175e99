"""The port's delivery rotation (tpu_splat_torch/export/transforms.py and
core/spz.rotate_180_about_x) against the JAX package's on one seeded
degree-3 cloud: SH rotation matrices, rotated and mirrored clouds within
1e-6, and the .spz bytes of the runner's rotated cloud equal."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_splat.core import spz as jspz
from tpu_splat.core.types import GaussianCloud as JCloud
from tpu_splat.export import transforms as jtr
from tpu_splat_torch.core import spz as tspz
from tpu_splat_torch.core.types import GaussianCloud as TCloud
from tpu_splat_torch.export import transforms as ttr

SPECS = ["x:270,y:180", "x:270,y:90", "x:180,y:180"]  # the runner's three


def seeded_clouds(n=64):
    rng = np.random.default_rng(8)
    a = dict(means=rng.normal(0, 2, (n, 3)), scales=rng.normal(-3, 0.5, (n, 3)),
             quats=rng.normal(0, 1, (n, 4)), opacities=rng.normal(0, 1, n),
             sh0=rng.normal(0, 0.5, (n, 3)), shN=rng.normal(0, 0.1, (n, 15, 3)))
    a = {k: v.astype(np.float32) for k, v in a.items()}
    return JCloud(**{k: jnp.asarray(v) for k, v in a.items()}), TCloud(**a)


def assert_clouds_close(got, want, atol=1e-6):
    for name in ("means", "scales", "quats", "opacities", "sh0", "shN"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)
    assert got.antialiased == want.antialiased


def test_sh_rotation_matrices_and_rotate_sh_match_reference():
    R = ttr.parse_rotation_spec("x:30,y:-75,z:110")
    np.testing.assert_array_equal(R, jtr.parse_rotation_spec("x:30,y:-75,z:110"))
    np.testing.assert_array_equal(ttr.axis_rotation("z", 33.0), jtr.axis_rotation("z", 33.0))
    got, want = ttr.sh_rotation_matrices(R, 3), jtr.sh_rotation_matrices(R, 3)
    assert [m.shape for m in got] == [(3, 3), (5, 5), (7, 7)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        np.testing.assert_allclose(g @ g.T, np.eye(len(g)), atol=1e-6)  # orthogonal
    shN = np.asarray(seeded_clouds()[1].shN, np.float64)
    np.testing.assert_allclose(ttr.rotate_sh(shN, R), jtr.rotate_sh(shN, R), atol=1e-6, rtol=0)


@pytest.mark.parametrize("spec", SPECS)
def test_rotate_splat_matches_reference(spec):
    ref, port = seeded_clouds()
    assert_clouds_close(ttr.rotate_splat(port, spec), jtr.rotate_splat(ref, spec))


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_mirror_splat_matches_reference(axis):
    ref, port = seeded_clouds()
    assert_clouds_close(ttr.mirror_splat(port, axis), jtr.mirror_splat(ref, axis))


def test_rotate_180_about_x_matches_reference():
    ref, port = seeded_clouds()
    assert_clouds_close(tspz.rotate_180_about_x(port), jspz.rotate_180_about_x(ref))


def test_delivered_spz_bytes_match_reference(tmp_path):
    """The runner's delivery chain, rotate x:270,y:180 then mirror x, packed
    to .spz: the same bytes from both packages."""
    ref, port = seeded_clouds()
    jspz.save_spz(jtr.mirror_splat(jtr.rotate_splat(ref, SPECS[0]), "x"),
                  str(tmp_path / "ref.spz"))
    tspz.save_spz(ttr.mirror_splat(ttr.rotate_splat(port, SPECS[0]), "x"),
                  str(tmp_path / "port.spz"))
    assert (tmp_path / "port.spz").read_bytes() == (tmp_path / "ref.spz").read_bytes()

"""The port's mesh-renderer oracle (tpu_splat_torch/core/meshrender.py)
against the JAX package's, on the CPU: the benchmark scene and orbit poses
are equal, render_mesh is bit-equal (both are the same host numpy), and
render_erp, whose cube faces the port stitches with its own
cubemap_to_erp, agrees within 1e-5: the faces are bit-equal, and the stitch
is held to 1e-5 by tests/test_torch_spherical.py (its f32 sines and cosines
of the ERP grid are not XLA's; here 2.3e-6 on 10 of 6144 values)."""

import numpy as np
import pytest
import torch

from tpu_splat.core import meshrender as jmr
from tpu_splat_torch.core import meshrender as tmr

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    return jmr.make_capture_scene(seed=7), tmr.make_capture_scene(seed=7)


def test_scene_and_orbit_match_reference(scenes):
    want, got = scenes
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for ang in (0.0, 1.3):
        np.testing.assert_array_equal(tmr.orbit_w2c(ang), jmr.orbit_w2c(ang))


def test_render_mesh_is_bit_equal(scenes):
    want, got = scenes
    w2c = jmr.orbit_w2c(0.7)
    args = (w2c, 90.0, 90.0, 48.0, 32.0, 96, 64)
    img = tmr.render_mesh(got, *args)
    np.testing.assert_array_equal(img, jmr.render_mesh(want, *args))
    assert img.shape == (64, 96, 3) and img.std() > 0.05


def test_render_erp_matches_reference(scenes):
    want, got = scenes
    eye = (0.5, -0.6, -3.0)
    erp = tmr.render_erp(got, eye, 32, 64, face_size=24, device="cpu")
    np.testing.assert_allclose(erp, jmr.render_erp(want, eye, 32, 64, face_size=24),
                               atol=1e-5, rtol=0)
    assert erp.shape == (32, 64, 3) and erp.std() > 0.05

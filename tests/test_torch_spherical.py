"""The port's 360-degree expansion (tpu_splat_torch/spherical/) against the
JAX package's tpu_splat/spherical/ on seeded ERP frames, on the CPU: the
projections and cubemap_to_erp within 1e-5, and
expand_equirectangular_captures (oval nodes, angled views, face removal)
with the same views in the same order, within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.core.config import SphericalCameraConfig as JSphericalConfig
from tpu_splat.spherical import pipeline as jpipe
from tpu_splat.spherical import projections as jproj
from tpu_splat_torch.core.config import SphericalCameraConfig as TSphericalConfig
from tpu_splat_torch.spherical import pipeline as tpipe
from tpu_splat_torch.spherical import projections as tproj

torch.set_num_threads(1)
TOL = 1e-5


def smooth_erps(n=4, h=64, w=128, seed=0):
    """Seeded low-frequency ERP frames, (n, h, w, 3) f32."""
    import cv2

    rng = np.random.default_rng(seed)
    return np.stack([cv2.resize(rng.uniform(0, 1, (h // 8, w // 8, 3)).astype(np.float32),
                                (w, h), interpolation=cv2.INTER_LINEAR) for _ in range(n)])


def test_projections_match_reference():
    rng = np.random.default_rng(1)
    erp = smooth_erps(1)[0]
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for got, want in zip(tproj.dirs_to_erp_xy(torch.from_numpy(dirs), 64, 128),
                         jproj.dirs_to_erp_xy(jnp.asarray(dirs), 64, 128)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    angles = [(0, 0), (90, 0), (-37.5, 20), (180, -75), (15, 40)]
    for yaw, pitch in angles:
        np.testing.assert_array_equal(tproj.rotation_yaw_pitch(yaw, pitch),
                                      jproj.rotation_yaw_pitch(yaw, pitch))
    rots = np.stack([tproj.rotation_yaw_pitch(y, p) for y, p in angles]).astype(np.float32)
    got = tproj.erp_to_perspective(torch.from_numpy(erp), torch.from_numpy(rots), 24, 32, 70.0)
    for i, rot in enumerate(rots):
        want = jproj.erp_to_perspective(jnp.asarray(erp), jnp.asarray(rot), 24, 32, 70.0)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=TOL, rtol=0)
    faces = tproj.erp_to_cubemap(torch.from_numpy(erp), 32)
    np.testing.assert_allclose(faces.numpy(), np.asarray(jproj.erp_to_cubemap(
        jnp.asarray(erp), 32)), atol=TOL, rtol=0)
    cube = rng.uniform(0, 1, (6, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(tproj.cubemap_to_erp(torch.from_numpy(cube), 64, 128).numpy(),
                               np.asarray(jproj.cubemap_to_erp(jnp.asarray(cube), 64, 128)),
                               atol=TOL, rtol=0)
    # the sampler's edges: x wraps (a tiny negative x lands on exactly w in
    # f32), y clamps at h - 1.001
    x = np.array([-1e-8, -0.5, 127.7, 0.2, -3.4, 300.0], np.float32)
    y = np.array([3.2, -1.0, 63.9, 15.5, 7.0, 70.0], np.float32)
    np.testing.assert_array_equal(
        tproj._bilinear_wrap(torch.from_numpy(erp), torch.from_numpy(x),
                             torch.from_numpy(y)).numpy(),
        np.asarray(jproj._bilinear_wrap(jnp.asarray(erp), jnp.asarray(x), jnp.asarray(y))))


@pytest.mark.parametrize("kw", [
    dict(cube_faces_to_remove="", use_oval_nodes=True, angled_up_views=True,
         angled_down_views=True),
    dict(cube_faces_to_remove="up,down"),
    dict(cube_faces_to_remove="front, Down", optimize_sequential_frame_order=False),
], ids=["oval-angled", "no-up-down", "no-front-down-unordered"])
def test_expansion_matches_reference(kw, monkeypatch):
    """4 ERP frames of 64x128 with face_size=32. Each frame is tinted by its
    index, so a view sampled from the wrong frame would show."""
    images = smooth_erps(4, seed=2) * np.linspace(0.6, 1.0, 4)[:, None, None, None]
    images = images.astype(np.float32)
    want = jpipe.expand_equirectangular_captures(images, JSphericalConfig(enable=True, **kw),
                                                 face_size=32)
    cfg = TSphericalConfig(enable=True, **kw)
    got = tpipe.expand_equirectangular_captures(images, cfg, face_size=32, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    assert len(got) == len(tpipe.view_sequence(4, cfg))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # batches of views gather from their own frames alike
    monkeypatch.setattr(tpipe, "_PIXELS_PER_BATCH", 5 * 32 * 32)
    np.testing.assert_array_equal(
        tpipe.expand_equirectangular_captures(images, cfg, face_size=32, device="cpu"), got)


def test_view_sequence_counts():
    cfg = TSphericalConfig(enable=True, cube_faces_to_remove="up,down")
    # 6 frames are all key frames: 4 faces x 6 + 3 faces x 6 x 4 connective views
    assert len(tpipe.view_sequence(6, cfg)) == 96
    assert tpipe._key_frame_indices(6) == jpipe._key_frame_indices(6)
    assert tpipe._key_frame_indices(40) == jpipe._key_frame_indices(40)
    if not torch.cuda.is_available():  # without a GPU the default device raises
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpipe.expand_equirectangular_captures(smooth_erps(1), cfg)

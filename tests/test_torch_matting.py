"""The port's matting (tpu_splat_torch/matting/) against the JAX package's
tpu_splat/matting/ on seeded inputs, on the CPU: MatNet's logits and
saliency on the bundled weights within 1e-4 (SAME padding at odd and even
sizes, antialiased downsampling), U2NetP on flax weights carried across
within 1e-4, the full U2Net's state-dict shapes against the flax init's,
background removal's binary masks in the u2net (MatNet), sam2 and saliency
modes equal but for at most 0.1% of pixels, and the host helpers exact."""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.matting import matnet as jmatnet
from tpu_splat.matting import remove as jremove
from tpu_splat.matting import synthdata as jsynth
from tpu_splat.matting import u2net as ju2net
from tpu_splat_torch.matting import matnet as tmatnet
from tpu_splat_torch.matting import remove as tremove
from tpu_splat_torch.matting import synthdata as tsynth
from tpu_splat_torch.matting import u2net as tu2net
from tpu_splat_torch.testing import composite_scene

torch.set_num_threads(1)


def test_bundled_weights_are_the_reference_bytes():
    paths = (jmatnet.bundled_weights_path(), tmatnet.bundled_weights_path())
    digests = [hashlib.sha256(open(p, "rb").read()).hexdigest() for p in paths]
    assert paths[0] != paths[1] and digests[0] == digests[1]
    assert os.path.dirname(paths[1]).endswith(os.path.join("tpu_splat_torch", "matting",
                                                           "weights"))
    params = jmatnet.load_params(paths[0])
    net = tmatnet.MatNet()
    net.load_state_dict(tmatnet.matnet_state_dict(params))  # strict: every key maps
    assert sum(p.numel() for p in net.parameters()) == sum(v.size for v in params.values())


@pytest.mark.parametrize("h,w", [(96, 128), (44, 54)])
def test_matnet_logits_match_reference(h, w):
    """44x54 runs odd sizes through the stride-2 layers (22 -> 11 -> 6,
    27 -> 14 -> 7), where SAME pads one pixel on each side, not 0 and 1."""
    x = np.random.default_rng(h).uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    params = jmatnet.load_params(jmatnet.bundled_weights_path())
    want = np.asarray(jax.jit(jmatnet.apply)(params, jnp.asarray(x)))
    net = tmatnet.load_matnet(tmatnet.bundled_weights_path(), "cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, h, w)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_matnet_saliency_matches_reference():
    """2 frames of 96x128: antialiased 256x256 downsampling in, upsampling out."""
    x = np.random.default_rng(5).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    got = tmatnet.matnet_saliency(x, device="cpu")
    want = jmatnet.matnet_saliency(x)
    assert got.shape == want.shape == (2, 96, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_u2net_small_matches_flax():
    """U2NetP at 64x64 on seeded flax variables (random batch statistics too)
    carried across with u2net_state_dict_from_flax."""
    rng = np.random.default_rng(2)
    shapes = jax.eval_shape(lambda: ju2net.U2Net(cfg="small").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.2, s.shape).astype(np.float32), shapes)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32), shapes["batch_stats"])
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: ju2net.u2net_apply(v, x, cfg="small"))(
        variables, jnp.asarray(x)))
    net = tu2net.U2Net("small")
    net.load_state_dict(tu2net.u2net_state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = tu2net.u2net_apply(net.eval(), torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_u2net_full_state_dict_loads_standard_keys(tmp_path):
    """cfg="full" (44,009,869 parameters) has the flax init's shapes, read
    through jax.eval_shape with no forward pass, and a state dict with the
    standard PyTorch keys loads with strict=True."""
    shapes = jax.eval_shape(lambda: ju2net.U2Net(cfg="full").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 320, 320, 3))))
    from_flax = tu2net.u2net_state_dict_from_flax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    net = tu2net.U2Net("full")
    sd = net.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in from_flax.items()}
    assert sum(p.numel() for p in net.parameters()) == 44_009_869
    assert "stage1.rebnconvin.conv_s1.weight" in sd and "side6.bias" in sd
    assert "stage5d.rebnconv1d.bn_s1.running_mean" in sd and "outconv.weight" in sd
    net.load_state_dict(from_flax, strict=True)
    # from a file, as a user's checkpoint arrives (U2NetP keeps the file small)
    path = str(tmp_path / "u2netp.pth")
    small = tu2net.U2Net("small").state_dict()
    torch.save(small, path)
    assert not tu2net.load_u2net(path, "cpu", cfg="small").training
    torch.save({k: v for k, v in small.items() if k != "side1.bias"}, path)
    with pytest.raises(RuntimeError, match="side1.bias"):
        tu2net.load_u2net(path, "cpu", cfg="small")


@pytest.mark.parametrize("model", ["u2net", "sam2", "saliency"])
def test_remove_background_matches_reference(model):
    """composite_scene(n=4): the u2net mode runs MatNet (no U2Net checkpoint
    is found), sam2 fuses MatNet with Farneback-warped masks, saliency runs
    GrabCut (seeded alike on both sides)."""
    images, _ = composite_scene(n=4)
    cv2 = pytest.importorskip("cv2")
    out = {}
    for pkg, fn, kw in (("ref", jremove.remove_background_batch, {}),
                        ("port", tremove.remove_background_batch, {"device": "cpu"})):
        cv2.setRNGSeed(0)
        out[pkg] = fn(images, model=model, keyframe_every=2, **kw)
    (gi, gm), (wi, wm) = out["port"], out["ref"]
    assert set(np.unique(gm)) <= {0.0, 1.0} and gm.shape == (4, 120, 160)
    assert np.mean(gm != wm) <= 1e-3
    assert 0.1 < gm.mean() < 0.6
    np.testing.assert_array_equal(gi, images * gm[..., None])


def test_mask_helpers_and_composites_are_exact():
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 1, (3, 40, 56, 3)).astype(np.float32)
    soft = rng.uniform(0, 1, (3, 40, 56)).astype(np.float32)
    gray16 = (soft * 65535).astype(np.uint16)
    for masks in (soft, (soft * 255).astype(np.uint8), gray16,
                  np.repeat((soft > 0.7)[..., None] * 255, 3, -1), np.zeros((3, 40, 56))):
        for got, want in zip(tremove.apply_mask_images(images, masks),
                             jremove.apply_mask_images(images, masks)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="must share"):
        tremove.apply_mask_images(images, soft[:2])
    blobs = (soft > 0.6).astype(np.float32)
    for m in blobs:
        np.testing.assert_array_equal(tremove.clean_mask(m), jremove.clean_mask(m))
    for a, b in zip(tsynth.make_composite(np.random.default_rng(9), 64, 80),
                    jsynth.make_composite(np.random.default_rng(9), 64, 80)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tsynth.make_batch(np.random.default_rng(1), 3, 32, 32),
                    jsynth.make_batch(np.random.default_rng(1), 3, 32, 32)):
        assert np.array_equal(a, b)


def test_matting_entry_points_refuse_without_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without one")
    images = np.zeros((1, 16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmatnet.matnet_saliency(images)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tremove.remove_background_batch(images, model="saliency")

"""MatNet's training path in the port (tpu_splat_torch/matting/train.py and
matnet's init_params, matnet_params and save_params) against the reference
(tpu_splat/matting/matnet.py and scripts/train_matnet.py's loss and update,
written here in JAX since the script keeps them in a closure), on the CPU:
the seeded init bit for bit, the weight file across both packages, step 1's
loss within 1e-4 relative and each gradient within 1e-4 of its largest
entry, and a three-step trajectory of the script's Adam at batch 2, 64x64
(which runs the stride-2 levels down to 8x8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.matting import matnet as jmatnet
from tpu_splat_torch.matting import matnet as tmatnet
from tpu_splat_torch.matting import train as ttrain

torch.set_num_threads(1)

STEPS, LR = 6, 3e-4  # the run's length sets the cosine decay: 0.93, 0.75, 0.5 of lr
N_STEPS = 3


@pytest.mark.parametrize("seed", [0, 1])
def test_init_params_are_the_reference_bits(seed):
    want = jmatnet.init_params(seed)
    got = tmatnet.init_params(seed)
    assert list(got) == list(want)  # the same draws in the same order
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_matnet_params_round_trips_the_state_dict():
    torch.manual_seed(0)
    net = tmatnet.MatNet()  # torch's own init: every weight and bias differs
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.randn_like(p))
    sd = net.state_dict()
    back = tmatnet.matnet_state_dict(tmatnet.matnet_params(net))
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    params = tmatnet.init_params(0)
    flat = tmatnet.matnet_params(tmatnet.matnet_state_dict(params))
    assert set(flat) == set(params)
    for k in params:
        assert np.array_equal(flat[k], params[k]), k


def test_saved_weights_load_in_both_packages(tmp_path):
    rng = np.random.default_rng(4)
    params = {k: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
              for k, v in tmatnet.init_params(0).items()}
    port, ref = str(tmp_path / "port" / "m.npz"), str(tmp_path / "ref" / "m.npz")
    tmatnet.save_params(params, port)
    jmatnet.save_params(params, ref)
    # zip timestamps differ, so the contents are compared, not the bytes
    with np.load(port) as zp, np.load(ref) as zr:
        assert zp.files == zr.files == list(params)
        for k in zr.files:
            assert zp[k].dtype == zr[k].dtype == np.float16 and np.array_equal(zp[k], zr[k])
    got, want = jmatnet.load_params(port), jmatnet.load_params(ref)
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    tmatnet.load_matnet(port, "cpu")  # strict: every key maps


def test_saving_over_a_cached_net_reloads_it(tmp_path):
    path = str(tmp_path / "m.npz")
    x = np.random.default_rng(1).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    tmatnet.save_params(tmatnet.init_params(0), path)
    first = tmatnet.matnet_saliency(x, path, device="cpu")
    tmatnet.save_params(tmatnet.init_params(1), path)
    second = tmatnet.matnet_saliency(x, path, device="cpu")
    net = tmatnet.load_matnet(path, "cpu")
    with torch.no_grad():
        want = torch.sigmoid(net(tmatnet.resize_bilinear(
            torch.from_numpy(x).permute(0, 3, 1, 2), (256, 256))))
        want = tmatnet.resize_bilinear(want[:, None], (32, 32))[:, 0].numpy()
    assert not np.array_equal(first, second)
    np.testing.assert_array_equal(second, np.clip(want, 0, 1))


def test_training_forward_matches_inference_in_f32_and_f64():
    """With gradients on, the decoder upsamples by matrix products that
    follow the input's dtype (the f64 net is the exact yardstick of the
    card's f32 gradients); without, by F.interpolate. 44x54 gives odd
    sizes (6 -> 11, 7 -> 14)."""
    net = tmatnet.MatNet()
    net.load_state_dict(tmatnet.matnet_state_dict(tmatnet.init_params(0)))
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, 3, 44, 54)))
    with torch.no_grad():
        want = net(x.float())
    train32 = net(x.float()).detach()
    train64 = net.double()(x).detach()
    assert train64.dtype == torch.float64 and train64.shape == want.shape == (1, 44, 54)
    np.testing.assert_allclose(train32.numpy(), want.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(train64.numpy(), want.numpy(), atol=1e-4, rtol=0)


def _batches():
    """N_STEPS batches of 2 images of 64x64 (smooth noise) and masks (a
    tilted ellipse each)."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    out = []
    for _ in range(N_STEPS):
        imgs = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
        masks = np.zeros((2, 64, 64), np.float32)
        for j in range(2):
            cx, cy, a, b = rng.uniform(20, 44), rng.uniform(20, 44), *rng.uniform(8, 20, 2)
            masks[j] = (((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2 < 1).astype(np.float32)
            imgs[j] = 0.6 * imgs[j] + 0.4 * masks[j][..., None] * rng.uniform(0, 1, 3)
        out.append((imgs, masks))
    return out


def _reference_trajectory(batches):
    """scripts/train_matnet.py's loss_fn and step, jitted as the script
    jits them; returns per step (loss, soft IoU, grads, params)."""

    def loss_fn(params, imgs, masks):
        logits = jmatnet.apply(params, imgs)
        bce = jnp.mean(
            jnp.maximum(logits, 0) - logits * masks
            + jnp.log1p(jnp.exp(-jnp.abs(logits))))
        p = jax.nn.sigmoid(logits)
        inter = jnp.sum(p * masks, axis=(1, 2))
        union = jnp.sum(p + masks - p * masks, axis=(1, 2))
        soft_iou = jnp.mean(inter / jnp.maximum(union, 1.0))
        return bce + 0.5 * (1.0 - soft_iou), soft_iou

    @jax.jit
    def step(params, opt_m, opt_v, imgs, masks, t):
        (loss, iou), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, imgs, masks)
        b1, b2, eps = 0.9, 0.999, 1e-8
        opt_m = jax.tree.map(lambda m, g: b1 * m + (1 - b1) * g, opt_m, grads)
        opt_v = jax.tree.map(lambda v, g: b2 * v + (1 - b2) * g * g, opt_v, grads)
        lr_t = LR * jnp.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        lr_t = lr_t * 0.5 * (1 + jnp.cos(jnp.pi * jnp.minimum(t / STEPS, 1.0)))
        params = jax.tree.map(
            lambda p, m, v: p - lr_t * m / (jnp.sqrt(v) + eps),
            params, opt_m, opt_v)
        return params, opt_m, opt_v, loss, iou, grads

    params = {k: jnp.asarray(v) for k, v in jmatnet.init_params(0).items()}
    opt_m = jax.tree.map(jnp.zeros_like, params)
    opt_v = jax.tree.map(jnp.zeros_like, params)
    out = []
    for i, (imgs, masks) in enumerate(batches, 1):
        params, opt_m, opt_v, loss, iou, grads = step(
            params, opt_m, opt_v, jnp.asarray(imgs), jnp.asarray(masks), jnp.float32(i))
        out.append((float(loss), float(iou), {k: np.asarray(g) for k, g in grads.items()},
                    {k: np.asarray(p) for k, p in params.items()}))
    return out


def _port_trajectory(batches):
    state = ttrain.init_train_state(0, "cpu")
    out = []
    for i, (imgs, masks) in enumerate(batches, 1):
        loss, iou = ttrain.train_step(state, imgs, masks, i, LR, STEPS)
        grads = tmatnet.matnet_params({k: p.grad for k, p in state.net.named_parameters()})
        out.append((float(loss), float(iou), grads, tmatnet.matnet_params(state.net)))
    return out


@pytest.fixture(scope="module")
def trajectories():
    batches = _batches()
    return _reference_trajectory(batches), _port_trajectory(batches)


def test_first_step_loss_and_gradients_match_reference(trajectories):
    (want_loss, want_iou, want_g, _), (loss, iou, g, _) = (t[0] for t in trajectories)
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    assert abs(iou - want_iou) <= 1e-4 * abs(want_iou)
    assert set(g) == set(want_g)
    for k in want_g:
        scale = float(np.abs(want_g[k]).max())
        assert scale > 0, k
        err = float(np.abs(g[k] - want_g[k]).max())
        assert err <= 1e-4 * scale, (k, err, scale)


def test_three_steps_of_the_scripts_adam_follow_reference(trajectories):
    """Parameters within 1e-3: Adam moves each entry by about lr a step
    whatever the gradient's size, so an entry whose gradient is near zero
    and of another sign in the two packages parts by about 2 lr a step. On
    this run 99.6% of the entries agree within 1e-5 (all of the run's
    489,425 at step 1), the largest gap is 2.0e-4."""
    ref, port = trajectories
    for i, ((want_loss, *_), (loss, *_)) in enumerate(zip(ref, port), 1):
        assert abs(loss - want_loss) <= 1e-4 * abs(want_loss), (i, loss, want_loss)
    want, got = ref[-1][3], port[-1][3]
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 1e-3, diffs.max()
    assert np.mean(diffs <= 1e-5) >= 0.99

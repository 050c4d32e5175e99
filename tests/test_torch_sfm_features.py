"""Parity of the port's SfM feature extraction and matching
(tpu_splat_torch/sfm/features.py, matching.py) with the JAX reference on the
CPU. Keypoints are compared as sets (the DoG contrast and extremum tests are
cliffs a last-bit difference can tip), descriptors of paired keypoints
elementwise, and matches as sets of valid pairs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.sfm import features as jfeat
from tpu_splat.sfm import matching as jmatch
from tpu_splat_torch.sfm import features as tfeat
from tpu_splat_torch.sfm import matching as tmatch

torch.set_num_threads(1)

SIZE = (120, 152)


def blob_image(rng, shift=(0.0, 0.0), n=400):
    """A grey image of random gaussian blobs (light and dark, 1.5-5 px)
    seen through a sub-pixel-shifted window; values in [0, 1]."""
    h, w = SIZE
    cx = rng.uniform(-10, w + 10, n)
    cy = rng.uniform(-10, h + 10, n)
    s = rng.uniform(1.5, 5.0, n)
    a = rng.choice([-1.0, 1.0], n) * rng.uniform(0.2, 0.5, n)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.full((h, w), 0.5)
    for i in range(n):
        img += a[i] * np.exp(-((xx + shift[0] - cx[i]) ** 2 + (yy + shift[1] - cy[i]) ** 2)
                             / (2 * s[i] ** 2))
    return np.clip(img, 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    state = rng.bit_generator.state
    a = blob_image(rng)
    rng.bit_generator.state = state  # same blobs, shifted window
    b = blob_image(rng, shift=(5.3, -2.7))
    return np.stack([a, b])


CFGS = {
    "plain": jfeat.FeatureConfig(max_features=256, num_octaves=3),
    "upsample": jfeat.FeatureConfig(max_features=256, num_octaves=2, upsample_first=True),
}


@pytest.fixture(scope="module")
def extracted(images):
    out = {}
    for name, cfg in CFGS.items():
        h, w = SIZE
        ref = [jax.tree.map(np.asarray, jfeat.extract_features(jnp.asarray(im), cfg, h, w))
               for im in images]
        tcfg = tfeat.FeatureConfig(**cfg.__dict__)
        got = tfeat.extract_features_batch(images, tcfg, device="cpu")
        out[name] = (ref, got)
    return out


@pytest.mark.parametrize("name", list(CFGS))
def test_features_match_reference(extracted, name):
    """>= 99% of the reference's valid keypoints have a port keypoint within
    1e-3 px at the same scale; paired descriptors within 1e-4 and
    orientations within 1e-4 rad."""
    ref, got = extracted[name]
    for i, r in enumerate(ref):
        v = r.valid
        assert v.sum() > 80
        gv = got.valid[i].numpy()
        gxy = got.xy[i].numpy()[gv]
        d = np.linalg.norm(r.xy[v][:, None] - gxy[None], axis=-1)
        j = np.argmin(d, axis=1)
        paired = (d[np.arange(len(j)), j] <= 1e-3) & np.isclose(
            r.scale[v], got.scale[i].numpy()[gv][j], rtol=1e-6)
        assert paired.mean() >= 0.99, f"image {i}: {paired.mean():.4f} paired"
        assert abs(int(gv.sum()) - int(v.sum())) <= 0.01 * v.sum()
        rd, gd = r.descriptor[v][paired], got.descriptor[i].numpy()[gv][j[paired]]
        assert np.max(np.abs(rd - gd)) <= 1e-4
        ro, go = r.orientation[v][paired], got.orientation[i].numpy()[gv][j[paired]]
        assert np.max(np.abs(np.angle(np.exp(1j * (ro - go))))) <= 1e-4


def test_upsample_is_bilinear_half_pixel():
    """jax.image.resize(linear) doubling == F.interpolate(bilinear,
    align_corners=False), borders included."""
    img = np.random.default_rng(1).uniform(0, 1, (9, 13)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (18, 26), "linear"))
    got = torch.nn.functional.interpolate(torch.from_numpy(img)[None, None], size=(18, 26),
                                          mode="bilinear", align_corners=False)[0, 0]
    assert np.max(np.abs(ref - got.numpy())) <= 1e-6


def test_matching_matches_reference(extracted):
    """Ratio/mutual matching and epipolar-guided matching on the reference's
    descriptors: equal sets of valid pairs, singly and batched over pairs."""
    ref, _ = extracted["plain"]
    da, db = (jnp.asarray(r.descriptor) for r in ref)
    va, vb = (jnp.asarray(r.valid) for r in ref)
    mj = jmatch.match_descriptors(da, va, db, vb, ratio=0.9, max_matches=256)
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    mt = tmatch.match_descriptors(t(da), t(va), t(db), t(vb), ratio=0.9, max_matches=256)

    def pair_set(m):
        idx, valid = np.asarray(m.idx), np.asarray(m.valid)
        return {tuple(p) for p in idx[valid].tolist()}

    ref_set = pair_set(mj)
    assert len(ref_set) > 40 and pair_set(mt) == ref_set
    desc = torch.stack([t(da), t(db)])
    valid = torch.stack([t(va), t(vb)])
    mb = tmatch.match_descriptors_pairs(desc, valid, np.array([[0, 1], [1, 0]]), ratio=0.9,
                                        max_matches=256)
    assert pair_set(tmatch.Matches(mb.idx[0], mb.valid[0])) == ref_set

    # guided: a pure translation along x, E = [t]x with t = (1, 0, 0)
    f, c = 100.0, np.array([SIZE[1] / 2, SIZE[0] / 2], np.float32)
    xa = (ref[0].xy - c) / f
    xb = (ref[1].xy - c) / f
    E = np.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    gj = jmatch.guided_match(da, va, jnp.asarray(xa), db, vb, jnp.asarray(xb), jnp.asarray(E),
                             3.0 / f, max_matches=256)
    gt = tmatch.guided_match_pairs(desc, valid, t(np.stack([xa, xb])), np.array([[0, 1]]),
                                   t(E[None]), torch.tensor([3.0 / f]), max_matches=256)
    assert len(pair_set(gj)) > 20
    assert pair_set(tmatch.Matches(gt.idx[0], gt.valid[0])) == pair_set(gj)


def test_pair_policies_match_reference():
    rng = np.random.default_rng(2)
    desc = rng.normal(size=(30, 16, 128)).astype(np.float32)
    val = rng.uniform(size=(30, 16)) < 0.8
    pos = rng.normal(size=(30, 3))
    for method in ("exhaustive", "sequential", "spatial", "vocab"):
        for n in (12, 30):
            kw = dict(positions=pos[:n] if method == "spatial" else None,
                      descriptors=desc[:n], valids=val[:n])
            assert np.array_equal(jmatch.select_pairs(method, n, **kw),
                                  tmatch.select_pairs(method, n, **kw))

"""Parity of the port's SfM geometry (tpu_splat_torch/sfm/geometry.py) with the
JAX reference on the CPU. The RANSACs draw their samples through the port's
`draw` hook from `jax.random.choice` on the reference's own three subkeys, so
both sides see the same hypotheses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.sfm import geometry as jgeo
from tpu_splat_torch.sfm import geometry as tgeo

torch.set_num_threads(1)


def max_rel(ref, got):
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(ref - np.asarray(got, np.float32))) / (np.max(np.abs(ref)) + 1e-12))


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def rot(rng, scale=0.3):
    return np.asarray(jgeo.exp_so3(jnp.asarray(rng.normal(0, scale, 3), jnp.float32)))


def two_views(rng, m=256, noise_px=0.3, outliers=0.25, focal=300.0):
    """Normalised correspondences of m points seen from two posed cameras:
    (x1n, x2n, valid, R, t, X). A quarter of the rows are outliers and the
    last 16 are invalid padding."""
    X = np.stack([rng.uniform(-1.5, 1.5, m), rng.uniform(-1, 1, m),
                  rng.uniform(3.0, 6.0, m)], 1).astype(np.float32)
    R = rot(rng, 0.08)
    tv = np.array([1.0, 0.1, 0.05], np.float32)
    x1 = X[:, :2] / X[:, 2:]
    pc = X @ R.T + tv
    x2 = pc[:, :2] / pc[:, 2:]
    x1 = x1 + rng.normal(0, noise_px / focal, x1.shape)
    x2 = x2 + rng.normal(0, noise_px / focal, x2.shape)
    bad = rng.uniform(size=m) < outliers
    x2[bad] = rng.uniform(-0.3, 0.3, (int(bad.sum()), 2))
    valid = np.ones(m, bool)
    valid[-16:] = False
    return (x1.astype(np.float32), x2.astype(np.float32), valid, R, tv, X)


def jax_draw(key):
    """The port's draw hook, replaying jax.random.choice on the subkeys the
    reference splits from `key`."""
    keys = jax.random.split(key, 3)

    def draw(stage, probs, n_hyp, n_sample):
        p = jnp.asarray(probs.numpy())
        idx = jax.random.choice(keys[stage], p.shape[0], shape=(n_hyp, n_sample), p=p)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))

    return draw


def test_so3_and_umeyama_match_reference():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1.0, (8, 3)).astype(np.float32)
    R = np.asarray(jgeo.exp_so3(jnp.asarray(w)))
    assert max_rel(R, tgeo.exp_so3(t(w))) <= 1e-5
    assert max_rel(jgeo.log_so3(jnp.asarray(R)), tgeo.log_so3(t(R))) <= 1e-5
    src = rng.normal(size=(40, 3)).astype(np.float32)
    dst = (2.5 * src @ rot(rng).T + np.array([1.0, -2.0, 0.5]) + rng.normal(0, 0.01, src.shape))
    dst = dst.astype(np.float32)
    for a, b in zip(jgeo.umeyama_alignment(jnp.asarray(src), jnp.asarray(dst)),
                    tgeo.umeyama_alignment(t(src), t(dst))):
        assert max_rel(a, b) <= 1e-5


def test_triangulation_matches_reference():
    """Two-view and multi-view DLT (Householder QR + inverse iteration), 1e-4
    relative; the multi-view batch has invalid views zeroed."""
    rng = np.random.default_rng(1)
    x1, x2, _, R, tv, X = two_views(rng, m=64, outliers=0.0)
    P1 = np.eye(3, 4, dtype=np.float32)
    P2 = np.concatenate([R, tv[:, None]], 1).astype(np.float32)
    ref = jgeo.triangulate_dlt(*map(jnp.asarray, (P1, P2, x1, x2)))
    assert max_rel(ref, tgeo.triangulate_dlt(t(P1), t(P2), t(x1), t(x2))) <= 1e-4

    n, v = 32, 5
    Ps = np.stack([np.concatenate([rot(rng, 0.1), rng.normal(0, 0.5, (3, 1))], 1)
                   for _ in range(v)]).astype(np.float32)
    Xw = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(4, 6, n)], 1)
    pc = np.einsum("vij,nj->nvi", Ps[:, :, :3], Xw) + Ps[None, :, :, 3]
    xs = (pc[..., :2] / pc[..., 2:] + rng.normal(0, 1e-3, (n, v, 2))).astype(np.float32)
    valid = rng.uniform(size=(n, v)) < 0.8
    valid[:, :2] = True
    Ps_b = np.broadcast_to(Ps, (n, v, 3, 4)).copy()
    ref = jax.vmap(jgeo.triangulate_multiview)(jnp.asarray(Ps_b), jnp.asarray(xs),
                                                jnp.asarray(valid))
    got = tgeo.triangulate_multiview(t(Ps_b), t(xs), torch.from_numpy(valid))
    assert max_rel(ref, got) <= 1e-4


def test_essential_ransac_and_decomposition_match_reference():
    """Inlier masks equal under the injected draws, E equal up to sign within
    1e-4, and the decomposed pose within 1e-4."""
    rng = np.random.default_rng(2)
    x1, x2, valid, R_gt, _, _ = two_views(rng)
    thr = 2.0 / 300.0
    key = jax.random.PRNGKey(3)
    E_j, inl_j = jgeo.essential_ransac(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
                                       key, threshold=thr)
    E_t, inl_t = tgeo.essential_ransac(t(x1), t(x2), torch.from_numpy(valid), thr,
                                       draw=jax_draw(key))
    E_j, inl_j = np.asarray(E_j), np.asarray(inl_j)
    assert np.array_equal(inl_j, inl_t.numpy())
    assert inl_j.sum() > 150
    sign = np.sign(np.sum(E_j * E_t.numpy()))
    assert max_rel(E_j, sign * E_t.numpy()) <= 1e-4

    Rj, tj = jgeo.decompose_essential(jnp.asarray(E_j), jnp.asarray(x1), jnp.asarray(x2),
                                      jnp.asarray(inl_j))
    Rt, tt = tgeo.decompose_essential(t(E_j), t(x1), t(x2), torch.from_numpy(inl_j))
    assert max_rel(Rj, Rt) <= 1e-4 and max_rel(tj, tt) <= 1e-4
    assert np.degrees(np.arccos(np.clip((np.trace(Rt.numpy() @ R_gt.T) - 1) / 2, -1, 1))) < 1.0


def test_essential_ransac_pairs_handles_empty_pairs():
    """The default multinomial draw on the batched form: a pair with no valid
    row draws from a zero distribution (torch.multinomial refuses those) and
    comes back with no inliers; the healthy pair beside it is found."""
    rng = np.random.default_rng(4)
    x1, x2, valid, _, _, _ = two_views(rng, m=128)
    xa = np.stack([x1, x1]).astype(np.float32)
    xb = np.stack([x2, x2]).astype(np.float32)
    va = np.stack([valid, np.zeros_like(valid)])
    gen = torch.Generator().manual_seed(0)
    E, inl = tgeo.essential_ransac_pairs(t(xa), t(xb), torch.from_numpy(va),
                                         torch.full((2,), 2.0 / 300.0), num_hypotheses=128,
                                         generator=gen)
    assert E.shape == (2, 3, 3) and inl.shape == (2, 128)
    assert int(inl[1].sum()) == 0 and int(inl[0].sum()) > 60


@pytest.mark.parametrize("n_cands", [1, 5])
def test_polish_jacobian_matches_forward_mode(n_cands):
    """The essential polish's closed-form Jacobian of the signed Sampson
    residuals equals a forward-mode one of the same residuals, in f64, for
    one candidate per pair and for a stack of candidates."""
    rng = np.random.default_rng(6)
    P, M = 3, 40
    p1 = tgeo._homogeneous(torch.from_numpy(rng.normal(0, 0.3, (P, M, 2))))[:, None]
    p2 = tgeo._homogeneous(torch.from_numpy(rng.normal(0, 0.3, (P, M, 2))))[:, None]
    u, vt = tgeo._proper_svd(torch.from_numpy(rng.normal(size=(P, n_cands, 3, 3))))
    R0 = u @ torch.tensor(tgeo._W90, dtype=torch.float64) @ vt
    t0 = u[..., :, 2]

    def E_of(q):
        t_ = t0 + q[..., 3:]
        t_ = t_ / torch.linalg.vector_norm(t_, dim=-1, keepdim=True)
        return tgeo.hat(t_) @ (tgeo.exp_so3(q[..., :3]) @ R0)

    def resid(q):
        num, den, _, _ = tgeo._sampson_terms(E_of(q), p1, p2)
        return num / torch.sqrt(torch.clamp_min(den, 1e-12))

    q = torch.from_numpy(rng.normal(0, 0.01, (P, n_cands, 6)))
    r, J = tgeo._signed_sampson_jacobian(E_of(q), tgeo._jacobian(lambda x: E_of(x).flatten(-2), q),
                                         p1, p2)
    J_fwd = tgeo._jacobian(resid, q)
    assert torch.allclose(r, resid(q), rtol=0, atol=1e-12)
    assert torch.allclose(J, J_fwd, rtol=1e-10, atol=1e-10 * float(J_fwd.abs().max()))


@pytest.fixture(scope="module")
def pnp_problem():
    rng = np.random.default_rng(5)
    m = 200
    R = rot(rng, 0.3)
    tv = np.array([0.3, -0.2, 0.5], np.float32)
    X = np.stack([rng.uniform(-1, 1, m), rng.uniform(-1, 1, m), rng.uniform(3, 5, m)], 1)
    X = (X - tv) @ R  # so that R X + t lands in front of the camera
    pc = X @ R.T + tv
    xn = pc[:, :2] / pc[:, 2:] + rng.normal(0, 0.5 / 300.0, (m, 2))
    bad = rng.uniform(size=m) < 0.2
    xn[bad] = rng.uniform(-0.4, 0.4, (int(bad.sum()), 2))
    valid = np.ones(m, bool)
    valid[-8:] = False
    return X.astype(np.float32), xn.astype(np.float32), valid, R, tv


def test_pnp_ransac_matches_reference(pnp_problem):
    X, xn, valid, _, _ = pnp_problem
    thr = 3.0 / 300.0
    key = jax.random.PRNGKey(7)
    Rj, tj, inl_j = jgeo.pnp_ransac(jnp.asarray(X), jnp.asarray(xn), jnp.asarray(valid), key,
                                    threshold=thr)
    Rt, tt, inl_t = tgeo.pnp_ransac(t(X), t(xn), torch.from_numpy(valid), thr,
                                    draw=jax_draw(key))
    assert np.array_equal(np.asarray(inl_j), inl_t.numpy())
    assert max_rel(Rj, Rt) <= 1e-4 and max_rel(tj, tt) <= 1e-4


def test_pnp_refinement_matches_reference(pnp_problem):
    """The annealed trimmed GN from a perturbed seed (a batch of two seeds on
    the port's side), and refine_pnp: R and t within 1e-4."""
    X, xn, valid, R, tv = pnp_problem
    rng = np.random.default_rng(6)
    seeds = [(rot(rng, 0.05) @ R, tv + rng.normal(0, 0.05, 3).astype(np.float32))
             for _ in range(2)]
    thr = 3.0 / 300.0
    R0 = np.stack([s[0] for s in seeds]).astype(np.float32)
    t0 = np.stack([s[1] for s in seeds]).astype(np.float32)
    Rt, tt, inl_t = tgeo.pnp_refine_annealed(t(R0), t(t0), t(X), t(xn),
                                             torch.from_numpy(valid), thr)
    for i in range(2):
        Rj, tj, inl_j = jgeo.pnp_refine_annealed(
            jnp.asarray(R0[i]), jnp.asarray(t0[i]), jnp.asarray(X), jnp.asarray(xn),
            jnp.asarray(valid), threshold=thr)
        assert np.array_equal(np.asarray(inl_j), inl_t[i].numpy())
        assert max_rel(Rj, Rt[i]) <= 1e-4 and max_rel(tj, tt[i]) <= 1e-4
    w = (rng.uniform(size=len(X)) < 0.7).astype(np.float32)
    Rj, tj = jgeo.refine_pnp(jnp.asarray(R0[0]), jnp.asarray(t0[0]), jnp.asarray(X),
                             jnp.asarray(xn), jnp.asarray(w))
    Rt, tt = tgeo.refine_pnp(t(R0[0]), t(t0[0]), t(X), t(xn), t(w))
    assert max_rel(Rj, Rt) <= 1e-4 and max_rel(tj, tt) <= 1e-4

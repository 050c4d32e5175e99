"""Global structure-from-motion: rotation averaging + position averaging
(the port of tpu_splat/sfm/global_mapper.py).

The GLOMAP-mapper analog (the reference selects it with sfm.softwareName=glomap,
main.py:1114-1154). Instead of registering cameras one at a time (incremental,
drift-prone), all pairwise relative poses are fused at once:

1. Front end shared with the incremental mapper: features, matching + essential
   verification, tracks; each verified pair also yields (R_ij, t_ij-direction),
   here from one batched essential RANSAC over every pair.
2. Robust iterative chordal rotation averaging (anchor R_0): every sweep sets
   each camera's rotation to the reweighted chordal mean of its neighbors'
   predictions and projects back to SO(3), all cameras at once.
3. Position averaging: the smallest right singular vector of the stacked
   cross-product constraints, then a track-braced joint camera + point solve.
4. Global triangulation of all tracks + observation filtering + extended bundle
   adjustment (shared with the incremental path).

The reference averages on the host in Python loops and `np.add.at`, in f64.
Here the same f64 arithmetic runs as batched tensor code on the device: pairs
are index tensors, per-camera sums over pairs are products with a pair-camera
incidence matrix, per-track and per-camera sums over rays are fixed-order
segment sums (ba.Segments; no atomics), and each round is one dense solve or
SVD. So two identical calls agree bit for bit on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.core.types import SfMScene
from tpu_splat_torch.sfm.ba import Segments
from tpu_splat_torch.sfm.geometry import decompose_essential_pairs, essential_ransac_pairs
from tpu_splat_torch.sfm.mapper import IncrementalMapper, MapperConfig

F64 = torch.float64


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=F64, device=device)


def _project_so3(mats: torch.Tensor) -> torch.Tensor:
    """Batched projection of (N, 3, 3) matrices onto SO(3). The result
    u diag(1, 1, det) vt does not depend on the SVD's choice of signs."""
    u, _, vt = torch.linalg.svd(mats)
    det = torch.linalg.det(u @ vt)
    fix = torch.ones(mats.shape[:-1], dtype=mats.dtype, device=mats.device)
    fix[..., 2] = torch.sign(det)
    return (u * fix[..., None, :]) @ vt


def _incidence(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(n, m) one-hot of a pair endpoint: row i sums the pairs that touch
    camera i, in a fixed order (a dense f64 product, no atomics)."""
    return torch.nn.functional.one_hot(idx, n).T.to(F64)


def rotation_averaging(
    n: int,
    pairs: List[Tuple[int, int]],
    rel_rots: List[np.ndarray],
    weights: List[float],
    iters: int = 50,
    device=None,
) -> np.ndarray:
    """Absolute w2c rotations from relative ones (R_j ~ R_ij R_i), anchor cam 0.

    Robust IRLS chordal averaging: neighbor predictions are averaged with Cauchy
    weights on the chordal residual, then projected to SO(3). The spanning-tree
    initialisation walks the pair graph on the host (f64 numpy, as the
    reference); the sweeps run on `device`."""
    dev = resolve_device(device)
    R0 = np.tile(np.eye(3), (n, 1, 1))
    # spanning-tree init: BFS from 0 through the pair graph
    adj: Dict[int, List[Tuple[int, np.ndarray]]] = {i: [] for i in range(n)}
    for (a, b), Rab in zip(pairs, rel_rots):
        adj[a].append((b, Rab))  # R_b = Rab @ R_a
        adj[b].append((a, Rab.T))
    seen = {0}
    frontier = [0]
    while frontier:
        nxt = []
        for i in frontier:
            for j, Rij in adj[i]:
                if j not in seen:
                    R0[j] = Rij @ R0[i]
                    seen.add(j)
                    nxt.append(j)
        frontier = nxt
    if not pairs:
        return R0

    R = _f64(R0, dev)
    pa = torch.as_tensor([a for a, _ in pairs], dtype=torch.long, device=dev)
    pb = torch.as_tensor([b for _, b in pairs], dtype=torch.long, device=dev)
    Rab = _f64(np.stack(rel_rots), dev)
    w = _f64(weights, dev)
    Ia, Ib = _incidence(pa, n), _incidence(pb, n)
    upd_ok = torch.ones(n, dtype=torch.bool, device=dev)
    upd_ok[0] = False
    eye = torch.eye(3, dtype=F64, device=dev)
    sigma = 0.2  # chordal scale for the Cauchy weight
    for _ in range(iters):
        pred_b = Rab @ R[pa]
        pred_a = Rab.mT @ R[pb]
        rb = torch.linalg.matrix_norm(pred_b - R[pb])
        ra = torch.linalg.matrix_norm(pred_a - R[pa])
        wb = w / (1.0 + (rb / sigma) ** 2)
        wa = w / (1.0 + (ra / sigma) ** 2)
        acc = (Ib @ (wb[:, None] * pred_b.reshape(-1, 9))
               + Ia @ (wa[:, None] * pred_a.reshape(-1, 9))).reshape(n, 3, 3)
        wsum = Ib @ wb + Ia @ wa
        # keep the anchor fixed; blend others toward the neighbor mean
        upd = (wsum > 0) & upd_ok
        mean = acc / torch.where(upd, wsum, torch.ones_like(wsum))[:, None, None]
        mixed = torch.where(upd[:, None, None], 0.5 * R + 0.5 * mean, R)
        R = _project_so3(mixed)
        R[0] = eye
    return R.cpu().numpy()


def _cross_mats(u: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(u[:, 0])
    return torch.stack([
        torch.stack([z, -u[:, 2], u[:, 1]], -1),
        torch.stack([u[:, 2], z, -u[:, 0]], -1),
        torch.stack([-u[:, 1], u[:, 0], z], -1),
    ], -2)


def position_averaging(
    n: int,
    pairs: List[Tuple[int, int]],
    world_dirs: List[np.ndarray],  # unit vector c_a -> c_b in world frame
    weights: List[float],
    irls_rounds: int = 3,
    device=None,
) -> np.ndarray:
    """Camera centers from pairwise direction constraints.

    Uses the linear cross-product form: (c_j - c_i) x u_ij = 0 is linear in the
    centers, so with c_0 anchored the solution is the smallest right singular
    vector of the stacked constraint matrix (global scale is the gauge freedom;
    the sign is fixed so most baselines point along their measured directions,
    so the SVD's own sign choice does not matter). A few IRLS rounds
    downweight outlier directions."""
    m = len(pairs)
    if m == 0 or n < 2:
        return np.zeros((n, 3))
    dev = resolve_device(device)
    U = _f64(np.stack(world_dirs), dev)  # (m, 3)
    w0 = torch.sqrt(_f64(weights, dev))
    w = w0
    pa = torch.as_tensor([a for a, _ in pairs], dtype=torch.long, device=dev)
    pb = torch.as_tensor([b for _, b in pairs], dtype=torch.long, device=dev)
    ar = torch.arange(m, device=dev)
    zero = torch.zeros((1, 3), dtype=F64, device=dev)
    for _ in range(irls_rounds):
        X = w[:, None, None] * _cross_mats(U)
        A = torch.zeros((m, 3, n, 3), dtype=F64, device=dev)
        A[ar, :, pa, :] = -X
        A[ar, :, pb, :] = X
        _, _, vt = torch.linalg.svd(A[:, :, 1:, :].reshape(3 * m, 3 * (n - 1)),
                                    full_matrices=False)
        c = torch.cat([zero, vt[-1].reshape(n - 1, 3)])
        # fix the sign so baselines align with their measured directions
        base = c[pb] - c[pa]
        dots = torch.sum(base * U, dim=1)
        flip = torch.sum(torch.sign(dots)) < 0
        c = torch.where(flip, -c, c)
        dots = torch.where(flip, -dots, dots)
        # IRLS: downweight pairs whose direction disagrees
        lens = torch.linalg.vector_norm(base, dim=1) + 1e-12
        cosang = dots / lens
        w = w0 / (1.0 + 5.0 * (1.0 - cosang) ** 2)
    # gauge: mean baseline 1
    scale = torch.mean(torch.linalg.vector_norm(base, dim=1))
    return (c / torch.clamp_min(scale, 1e-12)).cpu().numpy()


def global_positioning(
    n: int,
    centers_init: np.ndarray,          # (n, 3) from position_averaging
    cam_pairs: List[Tuple[int, int]],
    pair_dirs: np.ndarray,             # (m, 3) unit c_a -> c_b, world frame
    pair_w: np.ndarray,                # (m,)
    obs_cam: np.ndarray,               # (M,) camera index per observation
    obs_tid: np.ndarray,               # (M,) track index per observation
    obs_dir: np.ndarray,               # (M, 3) unit world ray camera -> point
    obs_w: np.ndarray,                 # (M,)
    n_tracks: int,
    rounds: int = 60,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Joint camera-center + track-point solve from ray directions (GLOMAP-style).

    The cam-cam chain alone (`position_averaging`) has near-null bending modes:
    on a closed ring only adjacent cameras constrain each other, so noise
    integrates along the loop. GLOMAP's global positioning step braces every
    pair of cameras that co-observe a track: minimize over centers c, points p,
    and per-ray depths d

        sum_obs w_ik ||p_k - c_i - d_ik v_ik||^2  +  sum_pairs w_ij ||(c_j - c_i) - s_ij u_ij||^2

    alternating (a) closed-form depths/baseline scales d, s (projections onto
    the fixed directions, floored away from zero), (b) IRLS reweighting by the
    depth-normalized residual, and (c) one exact linear solve for (c, p) with
    the points eliminated per-track (Schur complement), which reduces to a
    3-RHS (n-1)x(n-1) graph-Laplacian system over the covisibility graph, on
    `device` in f64.

    Returns (centers (n,3), points (n_tracks,3)); gauge: c_0 = 0, mean
    cam-cam baseline 1.
    """
    dev = resolve_device(device)
    c = _f64(centers_init, dev)
    mpair = len(cam_pairs)
    pa = torch.as_tensor([a for a, _ in cam_pairs], dtype=torch.long, device=dev)
    pb = torch.as_tensor([b for _, b in cam_pairs], dtype=torch.long, device=dev)
    U = _f64(pair_dirs, dev).reshape(mpair, 3)
    wp0 = _f64(pair_w, dev).reshape(mpair)
    oc = torch.as_tensor(np.asarray(obs_cam, np.int64), device=dev)
    ot = torch.as_tensor(np.asarray(obs_tid, np.int64), device=dev)
    V = _f64(obs_dir, dev)
    wo0 = _f64(obs_w, dev)
    per_track = Segments(ot, n_tracks)
    per_cam = Segments(oc, n)
    per_track_cam = Segments(ot * n + oc, n_tracks * n)
    D = _incidence(pb, n) - _incidence(pa, n)  # (n, m): +1 at b, -1 at a

    # initial points: midpoint triangulation from the init centers — per track
    # minimize sum_i ||(I - v v^T)(p - c_i)||^2, a batched 3x3 solve.
    eye = torch.eye(3, dtype=F64, device=dev)
    P_orth = eye - V[:, :, None] * V[:, None, :]   # (M, 3, 3)
    A = per_track(P_orth) + 1e-9 * eye
    b = per_track(torch.einsum("mij,mj->mi", P_orth, c[oc]))
    p = torch.linalg.solve_ex(A, b[:, :, None])[0][:, :, 0]

    scale0 = torch.ones((), dtype=F64, device=dev)
    if mpair:
        scale0 = torch.clamp_min(
            torch.mean(torch.linalg.vector_norm(c[pb] - c[pa], dim=1)), 1e-9)
    d_min = 1e-3 * scale0
    # Graduated non-convexity: the IRLS scale on the depth-normalized
    # (angular) residual anneals from wide-open to tight; round 0 uses unit
    # depths/scales, a convex pure direction-graph embedding.
    sigma_hi, sigma_lo = 1.0, 0.02
    wo = wo0
    wpair = wp0
    for r in range(rounds):
        if r == 0:
            d = torch.ones_like(wo0)
            s = torch.ones_like(wp0)
        else:
            sigma = max(sigma_lo, sigma_hi * (0.7 ** (r - 1)))
            # (a) closed-form depths / baseline scales
            rel = p[ot] - c[oc]
            d = torch.maximum(torch.sum(rel * V, dim=1), d_min)
            # (b) IRLS on the angular residual ||rel - d v|| / d
            res = torch.linalg.vector_norm(rel - d[:, None] * V, dim=1) / d
            wo = wo0 / (1.0 + (res / sigma) ** 2)
            if mpair:
                base = c[pb] - c[pa]
                s = torch.maximum(torch.sum(base * U, dim=1), d_min)
                resp = torch.linalg.vector_norm(base - s[:, None] * U, dim=1) / s
                wpair = wp0 / (1.0 + (resp / sigma) ** 2)

        # (c) eliminate points: p_k = (sum_i w(c_i + d v)) / S_k, then the
        # camera system is (L x I3) c = B with scalar Laplacian L.
        S = torch.clamp_min(per_track(wo), 1e-12)
        Wm = per_track_cam(wo).reshape(n_tracks, n)
        wdv = wo[:, None] * d[:, None] * V  # (M, 3)
        Vk = per_track(wdv)
        WmS = Wm / S[:, None]
        L = torch.diag(per_cam(wo)) - WmS.T @ Wm
        B = WmS.T @ Vk - per_cam(wdv)
        if mpair:
            L = L + (D * wpair) @ D.T
            B = B + D @ (wpair[:, None] * s[:, None] * U)

        # pin c_0 = 0 (translation gauge); tiny damping for isolated cameras
        lam = 1e-9 * torch.clamp_min(torch.trace(L) / max(n, 1), 1.0)
        Lr = L[1:, 1:] + lam * torch.eye(n - 1, dtype=F64, device=dev)
        c = torch.cat([torch.zeros((1, 3), dtype=F64, device=dev),
                       torch.linalg.solve(Lr, B[1:])])
        # recover points from the elimination
        p = (per_track(wo[:, None] * c[oc]) + Vk) / S[:, None]
        # scale gauge: mean cam-cam baseline 1 (pure rescale, keeps geometry)
        if mpair:
            g = torch.clamp_min(
                torch.mean(torch.linalg.vector_norm(c[pb] - c[pa], dim=1)), 1e-12)
            c = c / g
            p = p / g
    return c.cpu().numpy(), p.cpu().numpy()


class GlobalMapper(IncrementalMapper):
    """Global SfM sharing the incremental front end (features/matching/tracks)."""

    def _relative_poses(self):
        """Every verified pair's relative pose from one batched essential
        RANSAC (the mapper's generator) + decomposition. Returns (pairs,
        rel_rots, directions, weights) of the pairs with enough inliers, in
        pair_matches order, as the reference's per-pair loop keeps them."""
        keys = list(self.pair_matches)
        counts = [len(self.pair_matches[k]) for k in keys]
        m_max = max(counts)
        xa = np.zeros((len(keys), m_max, 2), np.float32)
        xb = np.zeros((len(keys), m_max, 2), np.float32)
        valid = np.zeros((len(keys), m_max), bool)
        for p, ((a, b), k) in enumerate(zip(keys, counts)):
            idx = self.pair_matches[(a, b)]
            xa[p, :k] = self._norm_coords(a, idx[:, 0])
            xb[p, :k] = self._norm_coords(b, idx[:, 1])
            valid[p, :k] = True
        xa_d, xb_d = self._t(xa), self._t(xb)
        thresh_n = self.cfg.pixel_threshold / self.fx
        E, inl = essential_ransac_pairs(
            xa_d, xb_d, self._t(valid, torch.bool),
            torch.full((len(keys),), thresh_n, device=self.device), generator=self.gen)
        n_inl = inl.sum(1).cpu().numpy()
        ok = np.nonzero(n_inl >= self.cfg.min_pair_inliers)[0]
        if len(ok) == 0:
            return [], [], [], []
        sel = torch.as_tensor(ok, device=self.device)
        Rrel, trel = decompose_essential_pairs(E[sel], xa_d[sel], xb_d[sel], inl[sel])
        Rrel = Rrel.cpu().numpy().astype(np.float64)
        trel = trel.cpu().numpy().astype(np.float64)
        return ([keys[i] for i in ok], list(Rrel), list(trel),
                [float(n_inl[i]) for i in ok])

    def _positioning_rays(self, R: np.ndarray, in_graph: np.ndarray):
        """The rays of the 20000 longest tracks (Python's stable sort by
        descending length; ties keep track order) restricted to the pair
        graph's cameras, tracks with >= 2 such rays, dense ids in that order.
        Returns (obs_cam, obs_tid, world ray directions, n_dense)."""
        oi, of, ot = self._flat_obs()
        lens = np.bincount(ot, minlength=len(self.tracks))
        order = np.argsort(-lens, kind="stable")[:20000]
        keep = in_graph[oi]
        n_in = np.bincount(ot[keep], minlength=len(self.tracks))
        chosen = order[n_in[order] >= 2]
        dense = np.full(len(self.tracks), -1, np.int64)
        dense[chosen] = np.arange(len(chosen))
        rows = np.nonzero(keep & (dense[ot] >= 0))[0]
        rows = rows[np.argsort(dense[ot[rows]], kind="stable")]
        obs_cam = oi[rows].astype(np.int64)
        obs_tid = dense[ot[rows]]
        xn = self._norm_coords_batch(oi[rows], of[rows]).astype(np.float64)
        rays = np.concatenate([xn, np.ones((len(rows), 1))], axis=1)
        rays /= np.linalg.norm(rays, axis=1, keepdims=True)
        # w2c: x_cam = R X + t -> world ray = R^T ray_cam
        obs_dir = np.einsum("nji,nj->ni", R[obs_cam], rays)
        return obs_cam, obs_tid, obs_dir, len(chosen)

    def reconstruct(self) -> SfMScene:
        if not self.pair_matches:
            raise RuntimeError("SfM failed to converge: no verified image pairs")
        with self._timed("relpose"):
            pairs, rel_rots, world_dirs_raw, weights = self._relative_poses()
        if not pairs:
            raise RuntimeError("SfM failed to converge: no relative poses")

        self.log(f"global: {len(pairs)} relative poses")
        with self._timed("rotation_avg"):
            R = rotation_averaging(self.n, pairs, rel_rots, weights, device=self.device)

        # camera-center directions in world: c_b - c_a ~ -R_a^T R_ab^T t_ab
        dirs = []
        for (a, b), Rab, tab in zip(pairs, rel_rots, world_dirs_raw):
            d = -R[a].T @ (Rab.T @ tab)
            dirs.append(d / max(np.linalg.norm(d), 1e-12))
        dirs = np.stack(dirs)
        with self._timed("position_avg"):
            centers = position_averaging(self.n, pairs, list(dirs), weights,
                                         device=self.device)

        # Track-braced global positioning: refine the chain-init centers with
        # camera->point ray constraints so co-observing cameras anywhere in
        # the graph are directly coupled (closed loops stop integrating noise).
        in_graph = np.zeros(self.n, bool)
        for a, b in pairs:
            in_graph[a] = in_graph[b] = True
        obs_cam, obs_tid, obs_dir, n_dense = self._positioning_rays(R, in_graph)
        if n_dense:
            self.log(f"global: positioning with {n_dense} tracks / "
                     f"{len(obs_cam)} rays")
            with self._timed("positioning"):
                centers, _ = global_positioning(
                    self.n, centers, pairs, dirs, np.asarray(weights, np.float64),
                    obs_cam, obs_tid, obs_dir, np.ones(len(obs_cam)), n_dense,
                    device=self.device,
                )

        self.R = R.astype(np.float32)
        self.t = np.stack([-R[i] @ centers[i] for i in range(self.n)]).astype(np.float32)
        # cameras in the pair graph count as registered
        self.registered = in_graph.copy()
        n_tracks = len(self.tracks)
        self.points = np.zeros((n_tracks, 3), np.float32)
        self.has_point = np.zeros(n_tracks, bool)
        self._attempts = np.zeros(self.n, np.int32)

        self._retriangulate()
        self._bundle_adjust()
        self._filter_observations()
        self._retriangulate()
        self._bundle_adjust(extended=True)
        self._filter_points()
        return self._to_scene()


def run_global_sfm(
    images: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    fx: Optional[float] = None,
    fy: Optional[float] = None,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    log_fn=None,
    device=None,
) -> SfMScene:
    """Global SfM entry point (the glomap-mapper analog), every phase on
    `device` (CUDA unless the CPU is asked for). It runs in full f32:
    `resolve_device` turns TF32 off on CUDA, the counterpart of the
    reference's default_matmul_precision("highest")."""
    cfg = cfg or MapperConfig()
    m = GlobalMapper(images, cfg, fx=fx, fy=fy, cx=cx, cy=cy, log_fn=log_fn, device=device)
    m.extract_all()
    m.match_all()
    m.build_tracks()
    scene = m.reconstruct()
    m._log_timers("done")
    return scene

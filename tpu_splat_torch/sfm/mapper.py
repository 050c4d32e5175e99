"""Incremental structure-from-motion mapper (the port of tpu_splat/sfm/mapper.py).

The COLMAP-mapper replacement: images -> camera poses + sparse points. Control
flow (registration order, track bookkeeping) runs on the host in numpy, as in
the reference; every numeric stage (feature extraction, matching, RANSAC,
triangulation, bundle adjustment) is a batched torch function from the sibling
modules, run on the mapper's device. Every phase runs there, reconstruction
included: the reference's move of that phase to the host CPU (a TPU tunnel
workaround) is not copied. Shapes are not padded to buckets: the padding
existed only to cache XLA compiles.

Pipeline:
 1. SIFT features per image (features.py), static top-K per image.
 2. Pair policy (matching.py) -> descriptor matching -> essential-RANSAC
    verification per pair; weak pairs discarded.
 3. Track building: union-find over (image, keypoint) observations.
 4. Initialization from the strongest verified pair (most inliers with enough
    parallax); triangulate its tracks.
 5. Incremental registration: next image = most 2D-3D correspondences ->
    progressive-RANSAC PnP -> triangulate its new tracks (multi-view DLT) ->
    periodic global bundle adjustment + outlier filtering.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.core.types import Cameras, SfMScene
from tpu_splat_torch.sfm.ba import BAProblem, bundle_adjust
from tpu_splat_torch.sfm.features import (FeatureConfig, Features, extract_features_batch,
                                          rgb_to_gray)
from tpu_splat_torch.sfm.geometry import (
    decompose_essential,
    decompose_essential_pairs,
    essential_ransac,
    essential_ransac_pairs,
    pnp_ransac,
    pnp_refine_annealed,
    triangulate_dlt,
    triangulate_multiview,
    umeyama_alignment,
)
from tpu_splat_torch.sfm.matching import (
    guided_match_pairs,
    match_descriptors_pairs,
    select_pairs,
)

@dataclass
class MapperConfig:
    feature: FeatureConfig = field(default_factory=FeatureConfig)
    matching_method: str = "sequential"
    exhaustive_max_images: int = 20
    ratio: float = 0.9
    max_matches_per_pair: int = 2048
    pixel_threshold: float = 4.0  # RANSAC / filtering threshold in pixels
    min_pair_inliers: int = 20
    min_pnp_inliers: int = 12
    min_triangulation_angle_deg: float = 1.5
    ba_every: int = 3  # global BA after this many new registrations
    # At scale the flat every-3 cadence is ~n/3 increasingly expensive global
    # BAs (50 at the reference's 150-image fast preset); like COLMAP's
    # ba_global_images_ratio, also require the model to have GROWN by this
    # factor since the last global BA, which caps the count at O(log n).
    ba_growth_ratio: float = 1.15
    ba_outer_iters: int = 10
    ba_cg_iters: int = 24
    max_reproj_error_px: float = 4.0
    focal_prior_factor: float = 1.2  # fx ~ 1.2 * max(w, h) when unknown
    # Intrinsics self-calibration (COLMAP refines intrinsics by default,
    # reference main.py:1090-1113). None = auto: refine exactly when no fx/fy
    # was supplied; True/False force it on/off.
    refine_intrinsics: Optional[bool] = None
    # Shared SIMPLE_RADIAL k1 estimation during self-calibration (COLMAP's
    # default camera model refines f AND k1; reference main.py:1090-1113).
    # Only active when intrinsics are being refined at all.
    refine_distortion: bool = True
    # Per-camera focal / principal-point polish on the CONVERGED map (COLMAP's
    # ba_refine_focal_length/ba_refine_principal_point per camera; the
    # reference turns this on for its pose-prior triangulator,
    # main.py:1090-1113). Off by default: single-camera captures are the norm
    # and a shared focal is better-conditioned there.
    refine_per_camera: bool = False
    seed: int = 0


class _NoInitPair(RuntimeError):
    """The map cannot be started: no verified pair, or none left that
    triangulates (the init-pair retry in `IncrementalMapper.reconstruct`
    catches this, and only this)."""


class _RestartWithFocal(Exception):
    """Raised by the focal multistart to request a from-scratch map rebuild
    under the calibrated focal (caught in `IncrementalMapper.reconstruct`)."""

    def __init__(self, fx: float):
        super().__init__(f"restart with fx={fx}")
        self.fx = fx


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, i):
        root = i
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[i] != root:
            self.parent[i], i = root, self.parent[i]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


class IncrementalMapper:
    """Host-side control of the reconstruction. Use run_sfm() for the one-call API."""

    def __init__(self, images: np.ndarray, cfg: MapperConfig,
                 fx: Optional[float] = None, fy: Optional[float] = None,
                 cx: Optional[float] = None, cy: Optional[float] = None,
                 log_fn=None, device=None):
        if images.ndim not in (3, 4):
            raise ValueError(f"images must be (N, H, W[, 3]), got shape {images.shape}")
        self.device = resolve_device(device)
        self.images = images
        self.n = images.shape[0]
        self.h, self.w = images.shape[1:3]
        self.cfg = cfg
        self.fx = fx or cfg.focal_prior_factor * max(self.w, self.h)
        self.fy = fy or self.fx
        self.cx = cx if cx is not None else self.w / 2
        self.cy = cy if cy is not None else self.h / 2
        self.calibrate = (cfg.refine_intrinsics if cfg.refine_intrinsics
                          is not None else fx is None)
        # Radial self-calibration (COLMAP's default SIMPLE_RADIAL estimates
        # k1 alongside f). Tracked separately from `calibrate` because the
        # focal-multistart rebuild clears `calibrate` once the focal is
        # decided, while the distortion decision happens later still — only
        # at endgame, by model selection (_refine_distortion_endgame).
        self.k1 = 0.0
        self._calib_k1 = self.calibrate and cfg.refine_distortion
        # per-camera endgame corrections (None until _refine_per_camera_intrinsics)
        self.percam_fscale: Optional[np.ndarray] = None
        self.percam_pp: Optional[np.ndarray] = None
        self.log = log_fn or (lambda s: None)
        # one generator, on the mapper's device, draws every RANSAC sample
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(cfg.seed)
        self._timers: Dict[str, float] = {}
        self._tcounts: Dict[str, int] = {}
        self._flat: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._xy_all: Optional[np.ndarray] = None
        self._last_ba_reg = 2
        self._attempts = np.zeros(self.n, np.int32)
        self._focal_refined_once = False
        # Quarantine for filtered observations: (img, tid) -> feat. Filtering
        # judges an observation under the focal/geometry of the moment; when
        # self-calibration later corrects the focal, early drops must be
        # re-testable or the map stays permanently sparse (see _readmit).
        self._dropped_obs: Dict[Tuple[int, int], int] = {}

    def _t(self, a, dtype=torch.float32) -> torch.Tensor:
        """Host array -> tensor on the mapper's device."""
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _ransac(self, xa: np.ndarray, xb: np.ndarray, threshold: float):
        """essential_ransac of one pair's correspondences. Returns (E, inl
        (M,) numpy, xa, xb) with E and the coordinates on the device."""
        xa_d, xb_d = self._t(xa), self._t(xb)
        E, inl = essential_ransac(
            xa_d, xb_d, torch.ones(len(xa), dtype=torch.bool, device=self.device),
            threshold, generator=self.gen)
        return E, inl.cpu().numpy(), xa_d, xb_d

    # ---------- phase timers ----------

    @contextlib.contextmanager
    def _timed(self, name: str):
        """Accumulate wall-clock per phase. At reference scale (150+ images)
        the round-3 full run spent 3400s in SfM with zero sub-stage
        visibility; every hot path charges a named bucket so long runs log
        where the wall went."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._timers[name] = (self._timers.get(name, 0.0)
                                  + time.perf_counter() - t0)
            self._tcounts[name] = self._tcounts.get(name, 0) + 1

    def _log_timers(self, tag: str):
        if not self._timers:
            return
        top = sorted(self._timers.items(), key=lambda kv: -kv[1])
        self.log(f"sfm timers [{tag}]: " + ", ".join(
            f"{k} {v:.2f}s/{self._tcounts[k]}x" for k, v in top))

    # ---------- vectorized observation store ----------
    #
    # self.tracks (list-of-lists) stays the source of truth for the
    # sequential control flow, but every O(observations) numeric pass
    # (BA gather, outlier filtering, retriangulation, readmission) runs on a
    # flat (obs_img, obs_feat, obs_tid) numpy mirror. The per-observation
    # Python loops these replace were the actual scale wall: at 150 images
    # (~500K observations x ~40 BA rounds) they cost more than every numeric
    # kernel combined (the reference's measurement). Invariant: within a track, the mirror's row order
    # equals the track list order (filter deletes in place, readmit appends
    # at the end on both sides); mutators that cannot cheaply preserve the
    # invariant call _invalidate_obs() and the mirror is rebuilt lazily.

    def _invalidate_obs(self):
        self._flat = None

    def _flat_obs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._flat is None:
            counts = np.fromiter((len(t) for t in self.tracks), np.int64,
                                 count=len(self.tracks))
            total = int(counts.sum())
            flat = np.empty((total, 2), np.int32)
            if total:
                flat_list = [o for t in self.tracks for o in t]
                flat[:] = flat_list
            obs_tid = np.repeat(
                np.arange(len(self.tracks), dtype=np.int32), counts)
            self._flat = (flat[:, 0].copy(), flat[:, 1].copy(), obs_tid)
        return self._flat

    def _xy_stack(self) -> np.ndarray:
        """(N, K, 2) pixel keypoints across all images (rows beyond an
        image's real keypoint count are garbage — only ever indexed through
        valid (img, feat) observation pairs)."""
        if self._xy_all is None:
            ks = [int(f.xy.shape[0]) for f in self.feats]
            kmax = max(ks)
            xy = np.zeros((self.n, kmax, 2), np.float32)
            for i, f in enumerate(self.feats):
                xy[i, :ks[i]] = np.asarray(f.xy)
            self._xy_all = xy
        return self._xy_all

    def _norm_coords_batch(self, imgs: np.ndarray,
                           feats: np.ndarray) -> np.ndarray:
        """Vectorized _norm_coords over (img, feat) observation arrays."""
        xy = self._xy_stack()[imgs, feats]
        uv = np.empty_like(xy, dtype=np.float32)
        uv[:, 0] = (xy[:, 0] - self.cx) / self.fx
        uv[:, 1] = (xy[:, 1] - self.cy) / self.fy
        if self.k1 != 0.0:
            xu = uv
            for _ in range(3):
                r2 = np.sum(xu * xu, axis=1, keepdims=True)
                xu = uv / (1.0 + self.k1 * r2)
            uv = xu.astype(np.float32)
        return uv

    # ---------- stage 1: features ----------

    def extract_all(self):
        with self._timed("extract"):
            self._extract_all_impl()

    def _extract_all_impl(self):
        imgs = torch.as_tensor(np.asarray(self.images, np.float32))
        gray = rgb_to_gray(imgs) if imgs.dim() == 4 else imgs
        fb = extract_features_batch(gray, self.cfg.feature, device=self.device)
        # descriptors stay on the device for matching; the host keeps numpy
        self._desc_d, self._valid_d = fb.descriptor, fb.valid
        fb_np = Features(*(a.cpu().numpy() for a in fb))
        feats = [Features(*(a[i] for a in fb_np)) for i in range(self.n)]
        self.feats = feats
        self._xy_all = None
        self.log(f"features: {self.n} images, "
                 f"{np.mean([f.valid.sum() for f in feats]):.0f} kps/image avg")

    # ---------- stage 2: matching + verification ----------

    def match_all(self):
        # Pinned to the accelerator even when invoked from the CPU-scoped
        # reconstruction phase (the focal-multistart rebuild re-matches):
        # descriptor matching is dense batched matmul, exactly what the
        # host CPU cannot do at 150-image scale.
        with self._timed("match"):
            self._match_all_impl()

    def _match_all_impl(self):
        cfg = self.cfg
        descs = np.stack([f.descriptor for f in self.feats])
        valids = np.stack([f.valid for f in self.feats])
        pairs = select_pairs(
            cfg.matching_method, self.n,
            exhaustive_max_images=cfg.exhaustive_max_images,
            descriptors=descs, valids=valids,
        )
        self.pair_matches: Dict[Tuple[int, int], np.ndarray] = {}
        self.pair_inliers: Dict[Tuple[int, int], int] = {}
        if len(pairs) == 0:
            self.log("matching: no candidate pairs")
            return
        pairs = np.asarray(pairs)
        # all pair matchings batched over pairs (one descriptor product each)
        mb = match_descriptors_pairs(
            self._desc_d, self._valid_d, pairs,
            ratio=cfg.ratio, max_matches=cfg.max_matches_per_pair,
        )
        mb_idx = mb.idx.cpu().numpy()
        mb_valid = mb.valid.cpu().numpy()
        counts = mb_valid.sum(1)
        cand = np.nonzero(counts >= cfg.min_pair_inliers)[0]
        if len(cand) == 0:
            self.log(f"matching: 0/{len(pairs)} pairs verified")
            return
        if self.calibrate:
            self._calibrate_focal(pairs, mb_idx, mb_valid, cand)
        thresh_n = cfg.pixel_threshold / self.fx

        # Essential-matrix verification of every candidate pair, batched over
        # pairs.
        xy = np.stack([f.xy for f in self.feats]).astype(np.float32)
        c = np.array([self.cx, self.cy], np.float32)
        f = np.array([self.fx, self.fy], np.float32)
        A, B = pairs[cand, 0], pairs[cand, 1]
        xa = (xy[A[:, None], mb_idx[cand, :, 0]] - c) / f
        xb = (xy[B[:, None], mb_idx[cand, :, 1]] - c) / f
        E_all, inl_all = essential_ransac_pairs(
            self._t(xa), self._t(xb), self._t(mb_valid[cand], torch.bool),
            torch.full((len(cand),), thresh_n, device=self.device), generator=self.gen,
        )
        E_all, inl_all = E_all.cpu().numpy(), inl_all.cpu().numpy()
        inl_counts = inl_all.sum(1)
        ok = inl_counts >= cfg.min_pair_inliers
        sel = cand[ok]
        if len(sel) == 0:
            self.log(f"matching: 0/{len(pairs)} pairs verified")
            return

        # Guided re-matching of the verified pairs, batched: with
        # E known, gate by the epipolar constraint instead of the ratio test —
        # recovers matches the conservative first pass dropped.
        xy_n = (xy - c) / f
        gm = guided_match_pairs(
            self._desc_d, self._valid_d, self._t(xy_n),
            pairs[sel], E_all[ok],
            np.full(len(sel), thresh_n, np.float32),
            max_matches=cfg.max_matches_per_pair,
        )
        gm_idx = gm.idx.cpu().numpy()
        gm_valid = gm.valid.cpu().numpy()
        for row, pi in enumerate(sel):
            a, b = int(pairs[pi, 0]), int(pairs[pi, 1])
            j = int(np.nonzero(cand == pi)[0][0])
            inl = inl_all[j]
            gidx = gm_idx[row][gm_valid[row]]
            if len(gidx) >= inl.sum():
                self.pair_matches[(a, b)] = gidx
                self.pair_inliers[(a, b)] = len(gidx)
            else:
                self.pair_matches[(a, b)] = mb_idx[pi][inl]
                self.pair_inliers[(a, b)] = int(inl.sum())
        self.log(f"matching: {len(self.pair_matches)}/{len(pairs)} pairs verified")

    def _calibrate_focal(self, pairs, mb_idx, mb_valid, cand):
        """Two-view focal sweep: score a grid of focal candidates by essential-
        RANSAC consensus on the strongest pairs (constant *pixel* tolerance)
        and adopt the best. This bootstraps self-calibration well enough for
        the mapper to converge; BA's shared log-focal parameter then refines it
        (COLMAP's mapper equivalently refines intrinsics during reconstruction)."""
        counts = mb_valid.sum(1)
        top = cand[np.argsort(-counts[cand])[:4]]
        factors = np.array([0.5, 0.65, 0.8, 1.0, 1.2, 1.45, 1.75], np.float32)
        f_list = factors * self.fx
        xy = np.stack([f.xy for f in self.feats]).astype(np.float32)
        c = np.array([self.cx, self.cy], np.float32)
        A, B = pairs[top, 0], pairs[top, 1]
        pxa = xy[A[:, None], mb_idx[top, :, 0]] - c  # (T, M, 2) centered pixels
        pxb = xy[B[:, None], mb_idx[top, :, 1]] - c
        xa = np.concatenate([pxa / f for f in f_list])  # (F*T, M, 2)
        xb = np.concatenate([pxb / f for f in f_list])
        val = np.tile(mb_valid[top], (len(f_list), 1))
        thr = np.repeat(self.cfg.pixel_threshold / f_list, len(top))
        _, inl = essential_ransac_pairs(
            self._t(xa), self._t(xb), self._t(val, torch.bool), self._t(thr),
            generator=self.gen,
        )
        score = inl.cpu().numpy().sum(1).reshape(len(f_list), len(top)).sum(1)
        best = int(np.argmax(score))
        base = int(np.nonzero(factors == 1.0)[0][0])
        # Two-view consensus vs focal is FLAT on focal-degenerate captures
        # (near-turntable orbits, forward-facing walks — measured +-1 inlier
        # across a 3.5x focal range on the e2e scenes): argmax of noise would
        # replace the sane 1.2*max(w,h) prior with a coin flip. Only override
        # the prior on a clear margin.
        if score[best] > 1.05 * score[base] + 2 and best != base:
            self.fx = self.fy = float(f_list[best])
            self.log(f"focal sweep: {factors[best]:.2f}x prior -> "
                     f"fx={self.fx:.1f} (consensus {score.tolist()})")
        else:
            self.log(f"focal sweep: flat consensus {score.tolist()}; "
                     f"keeping prior fx={self.fx:.1f}")

    def _norm_coords_all(self) -> np.ndarray:
        """(N, K, 2) normalized undistorted coords for every feature slot of
        every image — the batched form of _norm_coords the vmapped pair
        dispatches (guided matching, RANSAC verification) consume."""
        xy = self._xy_stack()  # (N, K, 2)
        uv = np.empty_like(xy, dtype=np.float32)
        uv[..., 0] = (xy[..., 0] - self.cx) / self.fx
        uv[..., 1] = (xy[..., 1] - self.cy) / self.fy
        if self.k1 != 0.0:
            xu = uv
            for _ in range(3):
                r2 = np.sum(xu * xu, axis=-1, keepdims=True)
                xu = uv / (1.0 + self.k1 * r2)
            uv = xu.astype(np.float32)
        return uv

    def _norm_coords(self, img_idx: int, feat_idx: np.ndarray) -> np.ndarray:
        """Pixel keypoints -> UNDISTORTED normalized coords under the current
        intrinsics estimate. The single normalization chokepoint: PnP,
        triangulation, essential RANSAC, and BA all consume these, so the
        whole mapper consistently works in pinhole space and the estimated k1
        only ever lives here (and in the export)."""
        feat_idx = np.asarray(feat_idx)
        return self._norm_coords_batch(
            np.full(feat_idx.shape, img_idx, np.int32), feat_idx)

    # ---------- stage 3: tracks ----------

    def build_tracks(self):
        with self._timed("tracks"):
            self._build_tracks_impl()

    def _build_tracks_impl(self):
        k = self.cfg.feature.max_features
        uf = _UnionFind(self.n * k)
        for (a, b), idx in self.pair_matches.items():
            for fa, fb in idx:
                uf.union(a * k + int(fa), b * k + int(fb))
        groups: Dict[int, List[Tuple[int, int]]] = {}
        for (a, b), idx in self.pair_matches.items():
            for fa, fb in idx:
                for node in (a * k + int(fa), b * k + int(fb)):
                    root = uf.find(node)
                    groups.setdefault(root, [])
        # second pass to fill observation lists; a track that claims two
        # different features in the same image is a faulty merge -> drop it.
        seen = {}
        bad_roots = set()
        for (a, b), idx in self.pair_matches.items():
            for fa, fb in idx:
                for img, feat in ((a, int(fa)), (b, int(fb))):
                    root = uf.find(img * k + feat)
                    key = (root, img)
                    if key not in seen:
                        seen[key] = feat
                        groups[root].append((img, feat))
                    elif seen[key] != feat:
                        bad_roots.add(root)
        # keep consistent tracks with >= 2 observations in distinct images
        self.tracks: List[List[Tuple[int, int]]] = [
            obs for root, obs in groups.items()
            if len(obs) >= 2 and root not in bad_roots
        ]
        # per-image: track_id -> feature, and the inverse (image, feature) -> track
        self.img_tracks: List[Dict[int, int]] = [dict() for _ in range(self.n)]
        self._feat_track: Dict[Tuple[int, int], int] = {}
        for tid, obs in enumerate(self.tracks):
            for img, feat in obs:
                self.img_tracks[img][tid] = feat
                self._feat_track[(img, feat)] = tid
        self._invalidate_obs()
        self.log(f"tracks: {len(self.tracks)} "
                 f"(mean length {np.mean([len(t) for t in self.tracks]):.1f})")

    # ---------- stage 4/5: reconstruction ----------

    def reconstruct(self) -> SfMScene:
        """Incremental reconstruction, with one full REBUILD if the focal
        multistart fires: a map bootstrapped under a wrong prior keeps a
        baked-in warp that later BAs cannot undo (measured: 2.7 center RMSE
        with all-healthy PnP registrations on the ring scene), so once the
        basin search has calibrated the focal, the cheapest clean map is a
        from-scratch regrowth under it. Matching and tracks are REBUILT too:
        the pair graph itself is focal-robust, but the epipolar-gated guided
        rematch is not — match sets grown under a 37%-wrong prior measurably
        poison init triangulation (67/84 vs 80/87 inliers triangulated) and
        every PnP margin downstream."""
        def one_attempt():
            try:
                return self._reconstruct()
            except _RestartWithFocal as r:
                self.log(f"rebuilding matches and map under calibrated "
                         f"fx={r.fx:.1f}")
                self.fx = self.fy = r.fx
                self.calibrate = False  # focal decided; regrow like a GT run
                self._dropped_obs = {}
                self._attempts = np.zeros(self.n, np.int32)
                self.match_all()
                self.build_tracks()
                return self._reconstruct()

        # Init-pair retry (COLMAP's initialization restarts): which pair
        # seeds the map decides whether the capture chain can grow at all —
        # an end-of-chain init can strand images whose tracks never reach
        # the map (measured: (0,1) init stalls the ring at 4/16 where the
        # mid-ring (10,11) registers everything). Retry from the next-best
        # pair while registration stays poor, keep the best map.
        self._init_exclude = set()
        best = None
        attempts = []  # full map state per attempt, for sub-model merging
        enough = self.n - max(2, self.n // 8)
        for attempt in range(3):
            try:
                scene = one_attempt()
            except _NoInitPair:
                if best is None:
                    raise  # nothing reconstructable at all
                break  # retries exhausted the init candidates; keep the best
            reg = int(np.asarray(scene.registered).sum())
            state = (reg, scene, self.R.copy(), self.t.copy(),
                     self.registered.copy(), self.points.copy(),
                     self.has_point.copy(), self.fx, self.fy, self.k1)
            attempts.append(state)
            if best is None or reg > best[0]:
                best = state
            if reg >= enough:
                break
            if self._init_pair is None:
                break
            self.log(f"init pair {self._init_pair} only grew {reg}/{self.n} "
                     f"cameras; retrying from the next-best pair")
            self._init_exclude.add(self._init_pair)
            self._dropped_obs = {}
            self._attempts = np.zeros(self.n, np.int32)
        if best[0] < enough and len(attempts) > 1:
            merged = self._merge_submodels(best, attempts)
            if merged is not None:
                return merged
        return best[1]

    def _reconstruct(self) -> SfMScene:
        cfg = self.cfg
        n_tracks = len(self.tracks)
        self.R = np.zeros((self.n, 3, 3), np.float32)
        self.t = np.zeros((self.n, 3), np.float32)
        self.registered = np.zeros(self.n, bool)
        self.points = np.zeros((n_tracks, 3), np.float32)
        self.has_point = np.zeros(n_tracks, bool)
        thresh_n = cfg.pixel_threshold / self.fx

        # Initialization: try the strongest verified pairs and keep the one whose
        # relative pose actually triangulates its tracks (guards against
        # critical-surface degeneracies where a wrong E still has high consensus).
        if not self.pair_matches:
            raise _NoInitPair("SfM failed to converge: no verified image pairs")
        exclude = getattr(self, "_init_exclude", set())
        cand_all = [
            p for p in sorted(
                self.pair_inliers, key=self.pair_inliers.get, reverse=True)
            if p not in exclude
        ]
        # Rank strong candidates by view-graph CENTRALITY before raw inlier
        # count: on chain-topology captures (orbits, walks) the strongest
        # pair is often a chain END (end views sit closest to the content),
        # and an end init grows the map one-sided — the far end arrives
        # through the longest possible drift chain, with thin PnP margins
        # and rescue scale-transfer warping on the way (measured: the same
        # ring reconstructs at 59% center RMSE from an end init vs 16% from
        # a central one). A central init halves the worst-case chain length.
        # COLMAP-equivalent concern: its init scoring also prefers pairs
        # that maximize downstream registrability, not just inliers.
        if cand_all:
            top_inl = self.pair_inliers[cand_all[0]]
            strong = [p for p in cand_all
                      if self.pair_inliers[p] >= 0.5 * top_inl][:12]
            adj: Dict[int, set] = {}
            for (i, j) in self.pair_inliers:
                adj.setdefault(i, set()).add(j)
                adj.setdefault(j, set()).add(i)

            def eccentricity(pair):
                frontier = set(pair)
                seen = set(pair)
                d = 0
                while frontier:
                    nxt = set()
                    for u in frontier:
                        nxt |= adj.get(u, set())
                    nxt -= seen
                    if not nxt:
                        break
                    seen |= nxt
                    frontier = nxt
                    d += 1
                return d

            candidates = sorted(
                strong,
                key=lambda p: (eccentricity(p), -self.pair_inliers[p]))[:5]
        else:
            candidates = []
        if not candidates:
            raise _NoInitPair(
                "SfM failed to converge: no initialization pair left")
        self._init_pair = None
        best = None  # (n_points, a, b, Rb, tb, points, has_point)
        done = False
        for (a, b) in candidates:
            # Two RANSAC restarts per candidate: the whole reconstruction
            # chains off this one two-view geometry, and on weak-texture
            # captures the consensus landscape is multi-modal — a single
            # unlucky draw here costs 15-20% of the init triangulations and
            # every downstream PnP margin with them. The early-accept bar is
            # deliberately high (0.85) for the same reason: a draw that only
            # triangulates 60-80% of its verified inliers is the signature of
            # a near-critical E, not of a hard pair.
            for _ in range(2):
                idx = self.pair_matches[(a, b)]
                xa = self._norm_coords(a, idx[:, 0])
                xb = self._norm_coords(b, idx[:, 1])
                E, inl, xa_d, xb_d = self._ransac(xa, xb, thresh_n)
                Rrel, trel = decompose_essential(
                    E, xa_d, xb_d, self._t(inl, torch.bool))
                self.R[a], self.t[a] = (np.eye(3, dtype=np.float32),
                                        np.zeros(3, np.float32))
                self.R[b], self.t[b] = Rrel.cpu().numpy(), trel.cpu().numpy()
                self.registered[:] = False
                self.registered[[a, b]] = True
                self.points[:] = 0
                self.has_point[:] = False
                self._triangulate_image_tracks([a, b])
                n_pts = int(self.has_point.sum())
                self.log(
                    f"init candidate ({a},{b}): "
                    f"{int(np.asarray(inl).sum())} inliers, "
                    f"{n_pts} triangulated"
                )
                if best is None or n_pts > best[0]:
                    best = (n_pts, a, b, self.R[b].copy(), self.t[b].copy(),
                            self.points.copy(), self.has_point.copy())
                if n_pts > 0.85 * self.pair_inliers[(a, b)]:
                    done = True
                    break  # good enough, stop searching
            if done:
                break
        n_pts, a, b, Rb, tb, pts, hp = best
        if n_pts < self.cfg.min_pnp_inliers:
            raise _NoInitPair(
                "SfM failed to converge: no initialization pair triangulates"
            )
        self._init_pair = (a, b)
        self.R[a], self.t[a] = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        self.R[b], self.t[b] = Rb, tb
        self.registered[:] = False
        self.registered[[a, b]] = True
        self.points, self.has_point = pts, hp
        self.log(f"init pair ({a},{b}): {n_pts} points")
        since_ba = 0
        self._attempts = np.zeros(self.n, np.int32)
        self._focal_refined_once = False
        self._dropped_obs = {}
        # Relative-pose rescues under an unrefined focal prior chain
        # self-consistent warped segments into the map; the final BA then fits
        # the shared focal TO the warp (locally optimal at ~1px rms, so
        # nothing downstream can detect it). While self-calibrating, rescues
        # are therefore disabled until either focal has been refined once
        # (clean PnP-only map reached 8 cams) or the mapper fully stalls
        # (desperation fallback below — a partial map beats none).
        rescue_ok = not self.calibrate
        tried_multistart = False
        min_inliers = cfg.min_pnp_inliers
        while True:
            nxt = self._next_image(min_inliers)
            if nxt is None:
                # More registrations unlock more triangulations (length-2 tracks
                # need both views registered) — retriangulate and retry before
                # concluding; then relax the visibility bar once (desperation
                # pass, like COLMAP's relaxed re-registration).
                self._retriangulate()
                nxt = self._next_image(min_inliers)
                # The desperation bar (6 inliers) poisons a self-calibrating
                # map exactly like rescues do — a 6-inlier PnP under a wrong
                # focal lands a warped camera BA then fits focal to — so it is
                # gated with them until focal has been refined.
                if nxt is None and min_inliers > 6 and rescue_ok:
                    min_inliers = 6
                    continue
                if nxt is None:
                    # last resort: bootstrap any image strongly paired with a
                    # registered one via two-view relative pose + scale transfer
                    nxt = self._next_relative_candidate() if rescue_ok else None
                    if nxt is None:
                        if not rescue_ok and not self.registered.all():
                            # Calibration-mode stall: strict PnP refusing every
                            # candidate this early is most likely the focal
                            # prior itself (reprojections warp ~uniformly with
                            # focal error). Two-view sweeps are flat on these
                            # captures, but map consistency is not — search
                            # focal basins by BA before resorting to rescues.
                            if (not tried_multistart
                                    and not self._focal_refined_once
                                    and self.registered.sum() >= 4):
                                tried_multistart = True
                                self._refine_focal_multistart()
                                self._attempts[~self.registered] = 0
                                continue
                            # Re-admit deferred images with rescues + the
                            # desperation bar enabled. One-shot.
                            rescue_ok = True
                            self._attempts[~self.registered] = 0
                            continue
                        break
            self._attempts[nxt] += 1
            ok = self._register_image(nxt, min_inliers)
            if (ok and self.calibrate and not self._focal_refined_once
                    and self.registered.sum() >= 8):
                # First focal decision, taken by basin search rather than by
                # letting BA refine in place: growth under a wrong prior
                # builds a self-consistent warped map that in-place joint
                # map+focal BA cannot leave (measured on the ring scenes:
                # 288 -> 261 vs GT 210, every camera registering happily,
                # 2x center RMSE). The search scores each focal basin by
                # out-of-map PnP consensus and posterior rms, then requests
                # a from-scratch regrowth under the winner.
                self._refine_focal_multistart()
            if not ok and self.calibrate and self._attempts[nxt] < 3:
                # Self-calibrating: a failed PnP is as likely a focal error as
                # a hard view — defer it. With >= 8 cams run BA (which refines
                # the shared focal) and retry; below 8 cams just requeue —
                # other candidates register PnP-only and grow the map until
                # focal refinement turns on, after which _bundle_adjust resets
                # the attempt counters of deferred images so they re-enter the
                # queue under the corrected focal.
                if self.registered.sum() >= 8:
                    self._bundle_adjust()
                    self._filter_observations()
                    since_ba = 0
                self._retriangulate()
                continue
            if self._focal_refined_once and not rescue_ok:
                # Focal has been refined on a clean PnP-only map; relative-
                # pose bootstraps are safe from here on.
                rescue_ok = True
            if not ok and rescue_ok:
                ok = self._register_via_relative_pose(nxt)
            if not ok:
                self.registered[nxt] = False
                continue
            self._triangulate_image_tracks([nxt])
            min_inliers = cfg.min_pnp_inliers  # rescue passes are one-shot
            since_ba += 1
            reg_now = int(self.registered.sum())
            if reg_now % 25 == 0:
                self._log_timers(f"{reg_now}/{self.n} registered")
            ba_gap = max(cfg.ba_every,
                         int(self._last_ba_reg * (cfg.ba_growth_ratio - 1.0)))
            if since_ba >= ba_gap:
                self._bundle_adjust()
                self._filter_observations()
                self._retriangulate()
                since_ba = 0
        self._bundle_adjust()
        self._readmit_observations()
        self._filter_observations()
        self._retriangulate()
        self._register_remaining()
        # Endgame convergence loop — three mutually-unlocking repairs,
        # iterated until none makes progress:
        #   stiffen: the verified pair graph of a walked capture is a chain
        #     (span 1-2), so scale drift accumulates toward the ends; with
        #     poses known, guided-match the unverified wide-baseline pairs
        #     into the tracks — the long-range constraints the final BA needs
        #     to pull the chain rigid (COLMAP's transitive match expansion).
        #   repair: re-PnP registered cameras whose observations dispute the
        #     converged map (rescue-seeded poses survive BA as outlier
        #     islands).
        #   admit: re-registration rounds for still-missing images — a chain
        #     end can only PnP once the sloppy segment next to it is repaired
        #     (measured: image 2 climbing 4/13 -> 7/13 -> registrable across
        #     these cycles).
        # Span schedule: near pairs first (3), widening to the full span 8.
        # The map-agreement gate compares each candidate against the CURRENT
        # (drifted) map, so a far pair is rejected exactly while the chain is
        # bent enough to need it — admitting span<=3 pairs first lets BA
        # straighten the chain so the wider spans can pass their gates on the
        # next round (one-shot span-8 gating is a knife edge: tiny numeric
        # perturbations flip which pairs survive, measured 16% <-> 39% final
        # drift on the ring benchmark).
        for span in (3, 5, 8, 8, 8):
            aug = self._augment_wide_pairs(max_span=span)
            if aug:
                self._retriangulate()
                self._filter_observations()  # purge bad links before BA
                self._bundle_adjust(extended=True)
            else:
                # no gate-passing pair: try the consensus-arbitrated trial
                # admissions (each does its own retriangulate + extended BA)
                aug = self._trial_admit_wide_pairs()
            fixed = self._reregister_weak_cameras()
            if fixed:
                self._filter_observations()
                self._retriangulate()
                self._bundle_adjust(extended=True)
            admitted = self._register_remaining()
            if span >= 8 and not (aug or fixed or admitted):
                break
        # NOTE: a glomap-style rotation-averaging pass over the final map was
        # tried here and measurably HURTS chain-topology captures (0.66 ->
        # 1.98 center RMSE on the open 240-degree ring): without loop-closure
        # pairs the averaged rotations inherit the same cumulative drift
        # while discarding BA's local polish. Rotation averaging remains
        # available as the explicit glomap-parity path
        # (global_mapper.run_global_sfm); do not bolt it onto the
        # incremental endgame without a loop-closure topology screen.
        # Final polish to CONVERGENCE, not to a fixed budget: a single
        # extended BA leaves open-chain captures materially under-converged
        # (measured on the 16-view 240-degree ring: iterating the
        # filter/retriangulate/BA cycle until the rms plateaus halves the
        # final camera-center drift, 39% -> ~19% of radius — the "drift
        # basin" is partly just an unfinished optimization). Each cycle also
        # re-triangulates with the improved poses, so observations move
        # between cycles; iterate until the rms improvement stalls (<0.5%)
        # or the cycle budget is spent (6 cycles ~ +50 s at 150 x 720p,
        # inside the SfM envelope).
        prev_rms = None
        # At scale each extended BA is ~30s; two polish cycles capture the
        # retriangulation benefit (the later cycles move rms <0.5% — and on
        # bend-stationary open chains, exactly 0).
        for _ in range(4 if self.n < 48 else 2):
            self._filter_observations()
            self._retriangulate()
            rms = self._bundle_adjust(extended=True)
            if rms is None or (prev_rms is not None and rms > 0.995 * prev_rms):
                break
            prev_rms = rms
        self._refine_distortion_endgame()
        self._refine_per_camera_intrinsics()
        self._filter_points()
        return self._to_scene()

    def _refine_per_camera_intrinsics(self):
        """Post-BA per-camera focal/principal-point polish (opt-in,
        cfg.refine_per_camera): a fixed-geometry closed-form fit per camera
        against the converged map (sfm/intrinsics.py). Results are stored as
        per-camera corrections and surface in the output Cameras — the map
        itself is not re-bent (the shared-focal BA owns the geometry)."""
        if not self.cfg.refine_per_camera or self.registered.sum() < 3:
            return
        cam_ids, live, obs_cam, obs_pt, obs_uv = self._gather_observations()
        if len(obs_cam) < 24:
            return
        from tpu_splat_torch.sfm.intrinsics import refine_intrinsics_per_camera

        problem = self._ba_problem(cam_ids, live, obs_cam, obs_pt, obs_uv)
        s, d, rms = refine_intrinsics_per_camera(problem)
        s, d = s.cpu().numpy(), d.cpu().numpy()
        self.percam_fscale = np.zeros((self.n,), np.float32)
        self.percam_pp = np.zeros((self.n, 2), np.float32)
        self.percam_fscale[cam_ids] = s
        self.percam_pp[cam_ids] = d
        self.percam_fscale[self.percam_fscale == 0.0] = 1.0
        self.log(
            f"per-camera intrinsics: focal x[{float(s.min()):.4f}, "
            f"{float(s.max()):.4f}], |pp| <= "
            f"{float(np.max(np.abs(d))) * self.fx:.2f}px, "
            f"rms {float(rms) * self.fx:.2f}px")

    def _refine_distortion_endgame(self):
        """Decide the shared SIMPLE_RADIAL k1 by model selection on the
        CONVERGED map (COLMAP upgrades camera models the same way: fit the
        richer model, keep it only if it wins decisively).

        k1 cannot be fit during map growth: on low-elevation captures
        (constant-height orbits/walks) the (f, k1) pair is near-degenerate,
        so a free k1 absorbs residual focal error and warps the geometry
        while the reprojection rms improves — measured on a pinhole ring:
        mid-growth k1 drifted to -0.05 and tripled camera-center RMSE. Fit
        on the final map instead, then accept only if the distorted model
        buys a decisive rms improvement over pinhole; otherwise restore the
        pinhole state byte-for-byte."""
        if not self._calib_k1 or self.registered.sum() < 4:
            return
        snapshot = self._snapshot_map
        restore = self._restore_map

        pinhole = snapshot()
        # Basin trials: a single in-place fit from k1=0 cannot move — the
        # border matches carrying the evidence failed pinhole RANSAC and
        # never entered the track graph, and the surviving mid-radius signal
        # is already absorbed into the converged (warped) geometry, so dk1's
        # gradient there is ~0 (measured: dk1 stayed +0.0000 on a capture
        # with true k1=-0.10). Each trial therefore REBUILDS the evidence
        # under its hypothesis: loose-readmit quarantined obs, re-gate the
        # short-span pairs' raw descriptor matches with guided matching
        # under the trial k1, retriangulate, then fit k1 by BA. The 0.0
        # trial is the CONTROL: it gets the identical readmit/re-gate/BA
        # treatment with k1 pinned, so the comparison isolates what the
        # distortion model explains — without it, every hypothesis beats
        # the raw baseline just by admitting extra (k1-insensitive,
        # mid-radius) matches the endgame never offered the pinhole model
        # (measured: a +0.05 fit "won" on a true k1=-0.10 capture).
        bases = (0.0, -0.2, -0.08, 0.12)
        trials = []
        for k1_base in bases:
            restore(pinhole)
            self.k1 = k1_base
            self._readmit_observations(slack=3.0)
            self._augment_wide_pairs(max_span=2, revisit=True)
            self._retriangulate()
            fit = k1_base != 0.0
            if self._bundle_adjust(extended=True, refine_k1=fit) is None:
                continue
            self._filter_observations()
            self._retriangulate()
            self._bundle_adjust(extended=True, refine_k1=fit)
            h, rms = self._obs_consensus()
            trials.append((h, rms, self.k1, k1_base, snapshot()))
        restore(pinhole)
        control = [t for t in trials if t[3] == 0.0]
        fits = [t for t in trials if t[3] != 0.0]
        if not control or not fits:
            return
        h0, rms0, _, _, _ = control[0]
        trace = ", ".join(f"{b:+.2f}:h{h}/r{r:.2f}px/k1={k:+.3f}"
                          for (h, r, k, b, _) in trials)
        h1, rms1, k1_fit, _, winner = max(fits, key=lambda tr: (tr[0], -tr[1]))
        # Acceptance must be DECISIVE (COLMAP model selection spirit): the
        # richer model wins only by explaining materially more observations
        # than the equally-treated control (the re-gated border evidence) at
        # no rms cost, or the same set materially better. Anything marginal
        # keeps pinhole — a free k1 always "improves" rms a hair by bending
        # along the (f, k1) ridge while silently warping the poses.
        accept = (0.01 <= abs(k1_fit) < 0.5
                  and ((h1 >= h0 + max(8, int(0.04 * h0))
                        and rms1 <= rms0 * 1.1)
                       or (h1 >= h0 and rms1 < 0.75 * rms0)))
        self.log(f"distortion multistart: {{{trace}}} -> "
                 + (f"k1={k1_fit:+.4f}" if accept else "pinhole"))
        # Keep the WINNING map either way. The control trial's rebuild
        # (loose readmit + short-span revisit + retriangulate + extended BA)
        # is valuable endgame work independent of the distortion question —
        # restoring the pre-trial baseline here threw away a 4K -> 30K point
        # map on the r4 fast-preset run and starved training of seeds.
        restore(winner if accept else control[0][4])

    def _snapshot_map(self):
        """Byte-for-byte copy of the full map state (poses, points, tracks,
        pair graph) for trial-and-restore flows (distortion multistart,
        wide-pair trial admission)."""
        import copy

        return (self.fx, self.fy, self.k1, self.R.copy(), self.t.copy(),
                self.points.copy(), self.has_point.copy(),
                copy.deepcopy(self.tracks),
                [dict(d) for d in self.img_tracks],
                dict(self._feat_track), dict(self._dropped_obs),
                dict(self.pair_matches), dict(self.pair_inliers))

    def _restore_map(self, s):
        import copy

        (self.fx, self.fy, self.k1, R, t, pts, hp, tracks, img_tracks,
         feat_track, dropped, pm, pi) = s
        self.R, self.t = R.copy(), t.copy()
        self.points, self.has_point = pts.copy(), hp.copy()
        self.tracks = copy.deepcopy(tracks)
        self.img_tracks = [dict(d) for d in img_tracks]
        self._feat_track = dict(feat_track)
        self._dropped_obs = dict(dropped)
        self.pair_matches = dict(pm)
        self.pair_inliers = dict(pi)
        self._invalidate_obs()

    def _trial_admit_wide_pairs(self, max_trials: int = 2) -> int:
        """Last-resort basin escape for bent open chains.

        The map-agreement gate in _augment_wide_pairs_impl measures a
        candidate's disagreement with the CURRENT map — on a drifted chain it
        rejects exactly the drift-correcting constraints (their disagreement
        IS the accumulated bend). Candidates with overwhelming self-consistent
        RANSAC support that failed only that angle gate are therefore admitted
        ON TRIAL: merge, retriangulate, extended BA — kept only if the global
        model then explains materially more observations at no rms cost (the
        same _obs_consensus arbitration the distortion multistart uses).
        Global arbitration is the only gate that can tell a drift corrector
        from a spurious plane-texture E: the corrector's links survive BA and
        straighten the chain; the spurious pair's links either get filtered
        (no consensus gain) or bend the map against every existing
        observation (rms cost). Runs only when the normal augment round made
        no progress, so healthy captures never pay for it."""
        cands = sorted(getattr(self, "_aug_trial_cands", []),
                       key=lambda c: -len(c[2]))
        if not cands:
            return 0
        accepted = 0
        for a_i, b_i, gidx, ang in cands[:max_trials]:
            snap = self._snapshot_map()
            h0, rms0 = self._obs_consensus()
            n_links = self._merge_matches_into_tracks(a_i, b_i, gidx)
            self.pair_matches[(a_i, b_i)] = gidx
            self.pair_inliers[(a_i, b_i)] = len(gidx)
            self._retriangulate()
            self._filter_observations()
            if self._bundle_adjust(extended=True) is None:
                self._restore_map(snap)
                continue
            h1, rms1 = self._obs_consensus()
            keep = ((h1 >= h0 + max(4, n_links // 2) and rms1 <= rms0 * 1.05)
                    or (h1 >= h0 and rms1 < 0.9 * rms0))
            self.log(
                f"trial wide pair ({a_i},{b_i}): {len(gidx)} matches, "
                f"dR {ang:.1f} deg, h {h0}->{h1}, rms {rms0:.2f}->{rms1:.2f}px "
                f"-> {'KEEP' if keep else 'restore'}")
            if keep:
                accepted += 1
            else:
                self._restore_map(snap)
        self._aug_trial_cands = []
        return accepted

    def _obs_consensus(self):
        """Model-comparison score for the distortion decision: the number of
        track observations (live + quarantined) the current model explains
        within the filter threshold, and the rms in px over the explained
        set. Counting the UNION with quarantined obs makes scores comparable
        across models that filtered differently — a model cannot win by
        dropping the observations it fails to explain."""
        max_err_n = self.cfg.max_reproj_error_px / self.fx
        per_img: List[List[Tuple[int, int]]] = [[] for _ in range(self.n)]
        for img in np.nonzero(self.registered)[0]:
            for tid, feat in self.img_tracks[int(img)].items():
                if self.has_point[tid]:
                    per_img[int(img)].append((tid, feat))
        for (img, tid), feat in self._dropped_obs.items():
            if self.registered[img] and self.has_point[tid]:
                per_img[img].append((tid, feat))
        count, sq = 0, 0.0
        for img in range(self.n):
            if not per_img[img]:
                continue
            tids = np.array([t for t, _ in per_img[img]], np.int64)
            feats = np.array([f for _, f in per_img[img]], np.int64)
            uv = self._norm_coords(img, feats)
            pc = self.points[tids] @ self.R[img].T + self.t[img]
            z = np.maximum(pc[:, 2:3], 1e-6)
            err = np.linalg.norm(pc[:, :2] / z - uv, axis=1)
            good = (pc[:, 2] > 1e-6) & (err < max_err_n)
            count += int(good.sum())
            sq += float((err[good] ** 2).sum())
        rms_px = float(np.sqrt(sq / max(count, 1))) * self.fx
        return count, rms_px

    def _merge_submodels(self, best, attempts):
        """COLMAP-style sub-model merging. Different init pairs can each grow
        a PARTIAL map covering different spans of a capture chain (an
        end-of-chain init strands the far end — measured: (0,1) grows cams
        0-3, (10,11) grows 3-15, and neither alone registers the ring).
        Align a donor attempt to the best one with a similarity transform
        over their COMMON track points, inject the donor's poses for the
        missing cameras (validated like rescues), then polish with the full
        endgame. Returns the merged scene, or None if no donor helps."""
        reg_b, _, Rb, tb, regb, ptsb, hpb, fxb, fyb, k1b = best
        self.R, self.t = Rb.copy(), tb.copy()
        self.registered = regb.copy()
        self.points, self.has_point = ptsb.copy(), hpb.copy()
        self.fx, self.fy, self.k1 = fxb, fyb, k1b
        injected = 0
        for st in attempts:
            if st is best:
                continue
            reg_d, _, Rd, td, regd, ptsd, hpd, fxd, fyd, k1d = st
            if (len(hpd) != len(hpb) or abs(fxd - fxb) > 0.01 * fxb
                    or abs(k1d - k1b) > 0.02):
                continue  # incompatible track space / intrinsics (rebuild)
            new_cams = np.nonzero(regd & ~self.registered)[0]
            common = np.nonzero(hpd & hpb)[0]
            if len(new_cams) == 0 or len(common) < 8:
                continue
            s, Rot, tr = umeyama_alignment(self._t(ptsd[common]), self._t(ptsb[common]))
            s, Rot, tr = float(s), Rot.cpu().numpy(), tr.cpu().numpy()
            # donor world -> best world: X_b = s * Rot @ X_d + tr. A donor
            # pose (R_i, t_i) then maps X_b to s * (camera coords), and
            # projection is invariant to positive scaling of camera space:
            #   R_new = R_i Rot^T,  t_new = s t_i - R_new tr
            thresh = 3.0 * self.cfg.max_reproj_error_px / self.fx
            for i in new_cams:
                R_new = (Rd[i] @ Rot.T).astype(np.float32)
                t_new = (s * td[i] - R_new @ tr).astype(np.float32)
                tids = [t_ for t_ in self.img_tracks[i] if self.has_point[t_]]
                if len(tids) >= 4:
                    feats = np.array([self.img_tracks[i][t_] for t_ in tids])
                    xn = self._norm_coords(int(i), feats)
                    pc = self.points[tids] @ R_new.T + t_new
                    z = np.maximum(pc[:, 2], 1e-9)
                    err = np.where(
                        pc[:, 2] > 1e-6,
                        np.linalg.norm(pc[:, :2] / z[:, None] - xn, axis=-1),
                        np.inf)
                    if float(np.median(err)) > thresh:
                        continue
                self.R[i], self.t[i] = R_new, t_new
                self.registered[i] = True
                injected += 1
                self.log(f"merged camera {int(i)} from a sibling sub-model "
                         f"(alignment over {len(common)} shared points)")
        if injected == 0:
            return None
        self._retriangulate()
        self._filter_observations()
        self._bundle_adjust(extended=True)
        self._reregister_weak_cameras()
        self._register_remaining()
        self._filter_observations()
        self._retriangulate()
        self._bundle_adjust(extended=True)
        self._filter_points()
        return self._to_scene()

    def _register_remaining(self) -> int:
        """Re-registration rounds for still-unregistered images, iterated to
        closure (each admission unlocks the next image's triangulations, so a
        single pass cannot recover an orphaned chain segment). BA every few
        admissions like the main loop; stop when a full pass admits nothing
        (COLMAP's post-BA re-registration rounds)."""
        total = 0
        for _ in range(3):
            if self.registered.all():
                break
            swept = 0
            progress = True
            while progress:
                progress = False
                for i in np.nonzero(~self.registered)[0]:
                    if self._register_image(int(i)):
                        self._triangulate_image_tracks([int(i)])
                        swept += 1
                        progress = True
                        if swept % 3 == 0:
                            self._bundle_adjust()
                            self._filter_observations()
                            self._retriangulate()
            if not swept:
                break
            total += swept
            self._readmit_observations()
            self._filter_observations()
            self._retriangulate()
            self._bundle_adjust(extended=True)
        return total

    def _reregister_weak_cameras(self) -> int:
        """Re-PnP cameras whose observations disagree with the converged map.

        Relative-pose rescue registrations can land a camera on a locally-
        consistent but globally-wrong pose that survives BA as an outlier
        island (its own observations get filtered instead of pulling it in).
        With the rest of the map converged, plain annealed PnP from the map
        recovers such cameras (COLMAP's equivalent is its re-registration of
        under-constrained images after global BA). Returns the repair count."""
        n_fixed = 0
        max_err_n = self.cfg.max_reproj_error_px / self.fx
        for i in np.nonzero(self.registered)[0]:
            tids = [tid for tid in self.img_tracks[i] if self.has_point[tid]]
            if len(tids) < self.cfg.min_pnp_inliers:
                continue
            feats = np.array([self.img_tracks[i][tid] for tid in tids])
            xn = self._norm_coords(i, feats)
            pc = self.points[tids] @ self.R[i].T + self.t[i]
            z = np.maximum(pc[:, 2], 1e-9)
            err = np.linalg.norm(pc[:, :2] / z[:, None] - xn, axis=-1)
            err = np.where(pc[:, 2] > 1e-6, err, np.inf)
            med = float(np.median(err))
            if med <= max_err_n:
                continue
            old_R, old_t = self.R[i].copy(), self.t[i].copy()
            if self._register_image(int(i)):
                n_fixed += 1
                self.log(f"re-registered weak camera {i} "
                         f"(median err was {med * self.fx:.1f}px)")
            else:
                self.R[i], self.t[i] = old_R, old_t
        return n_fixed

    def _filter_observations(self):
        """Drop individual track observations whose reprojection error exceeds the
        threshold (and kill points left with < 2 registered observations). The
        COLMAP-style post-BA cleanup that keeps outlier matches from pulling BA."""
        with self._timed("filter"):
            self._filter_observations_impl()

    def _filter_observations_impl(self):
        max_err_n = self.cfg.max_reproj_error_px / self.fx
        oi, of, ot = self._flat_obs()
        judged = self.has_point[ot] & self.registered[oi]
        idx = np.nonzero(judged)[0]
        if len(idx):
            ji, jf, jt = oi[idx], of[idx], ot[idx]
            pc = np.einsum("nij,nj->ni", self.R[ji], self.points[jt]) \
                + self.t[ji]
            front = pc[:, 2] > 1e-6
            z = np.where(front, pc[:, 2], 1.0)
            err = np.linalg.norm(
                pc[:, :2] / z[:, None] - self._norm_coords_batch(ji, jf),
                axis=1)
            bad = ~front | (err > max_err_n)
        else:
            bad = np.zeros(0, bool)
        drop_rows = idx[bad]
        n_dropped = len(drop_rows)
        if n_dropped:
            # quarantine + pop the per-image dicts (small python pass over
            # the DROPPED set only), then rebuild the track lists of the
            # affected tids and mask the mirror in place
            affected: Dict[int, set] = {}
            for r in drop_rows:
                img, feat, tid = int(oi[r]), int(of[r]), int(ot[r])
                self._dropped_obs[(img, tid)] = feat
                self.img_tracks[img].pop(tid, None)
                affected.setdefault(tid, set()).add((img, feat))
            for tid, gone in affected.items():
                self.tracks[tid] = [o for o in self.tracks[tid]
                                    if o not in gone]
            keep = np.ones(len(oi), bool)
            keep[drop_rows] = False
            self._flat = (oi[keep], of[keep], ot[keep])
            oi, of, ot = self._flat
        # kill points left with < 2 registered observations (judged tracks
        # only — same contract as the per-track loop this replaces)
        live = np.nonzero(self.has_point)[0]
        reg_count = np.bincount(ot[self.registered[oi]],
                                minlength=len(self.has_point))
        self.has_point[live] = reg_count[live] >= 2
        if n_dropped:
            self.log(f"filter: dropped {n_dropped} observations")

    def _retriangulate(self):
        """Attempt triangulation of all not-yet-triangulated tracks with >= 2
        registered observations (coverage grows as cameras register/BA improves)."""
        self._triangulate_image_tracks(list(np.nonzero(self.registered)[0]))

    def _readmit_observations(self, slack: float = 1.0) -> int:
        """Re-test quarantined observations against the CURRENT map and
        restore the ones that now reproject within threshold.

        `_filter_observations` judges under the focal/geometry of the moment —
        drops made under a wrong focal prior are wrong once self-calibration
        corrects it, and the resulting permanent sparsity is what collapses
        later PnP margins into rescue chains (measured: 2.6 center RMSE from
        compounding rescue scale transfer on the ring scene). COLMAP's
        retriangulation equivalently re-tests previously-discarded matches.

        `slack` loosens the acceptance threshold (used by the distortion
        multistart: obs dropped under the pinhole model sit BEYOND the normal
        threshold until the k1 fit explains them — Huber weighting in the
        subsequent BA keeps the moderately-off readmissions from pulling)."""
        with self._timed("readmit"):
            max_err_n = self.cfg.max_reproj_error_px * slack / self.fx
            if not self._dropped_obs:
                return 0
            items = list(self._dropped_obs.items())
            arr = np.fromiter(
                (v for (img, tid), feat in items for v in (img, tid, feat)),
                np.int64, count=3 * len(items)).reshape(-1, 3)
            di, dt, df = arr[:, 0], arr[:, 1], arr[:, 2]
            # tracks may have grown since an obs was quarantined
            alive = self.registered[di] & self.has_point[dt]
            cand = np.nonzero(alive)[0]
            if len(cand):
                ci, ct, cf = di[cand], dt[cand], df[cand]
                pc = np.einsum("nij,nj->ni", self.R[ci], self.points[ct]) \
                    + self.t[ci]
                front = pc[:, 2] > 1e-6
                z = np.where(front, pc[:, 2], 1.0)
                err = np.linalg.norm(
                    pc[:, :2] / z[:, None]
                    - self._norm_coords_batch(ci, cf), axis=1)
                back = cand[front & (err <= max_err_n)]
            else:
                back = np.zeros(0, np.int64)
            n_back = len(back)
            if n_back:
                oi, of, ot = self._flat_obs()
                for r in back:
                    img, tid, feat = int(di[r]), int(dt[r]), int(df[r])
                    self.tracks[tid].append((img, feat))
                    self.img_tracks[img][tid] = feat
                    del self._dropped_obs[(img, tid)]
                # mirror invariant: readmits append at the track-list end AND
                # at the mirror end, so per-track relative order stays equal
                self._flat = (
                    np.concatenate([oi, di[back].astype(np.int32)]),
                    np.concatenate([of, df[back].astype(np.int32)]),
                    np.concatenate([ot, dt[back].astype(np.int32)]),
                )
                self.log(f"readmit: {n_back} observations restored")
            return n_back

    def _augment_wide_pairs(self, max_span: int = 8,
                            revisit: bool = False) -> int:
        """Pose-guided matching of registered pairs the ratio test couldn't
        verify: derive E from the current relative pose, epipolar-gate the
        descriptor matches, and merge the results into the track graph.
        Returns the number of newly verified pairs.

        With `revisit`, already-verified pairs are re-matched too (the
        distortion multistart needs this: a verified pair's inlier set was
        gated under the PINHOLE normalization, so the border matches that
        carry the k1 evidence never reached the track graph — re-gating under
        the k1 hypothesis is what admits them)."""
        with self._timed("augment"):
            return self._augment_wide_pairs_impl(max_span, revisit)

    def _augment_wide_pairs_impl(self, max_span: int = 8,
                                 revisit: bool = False) -> int:
        reg = np.nonzero(self.registered)[0]
        cfg = self.cfg
        thresh_n = cfg.pixel_threshold / self.fx
        self._aug_trial_cands: List[Tuple[int, int, np.ndarray, float]] = []

        # Host-side candidate collection: pose-derived E per pair (cheap numpy).
        # relative pose a->b (x_b = R x_a + t), E = [t]x R — the same
        # convention guided_match gates with (p_b^T E p_a = 0)
        cand: List[Tuple[int, int]] = []
        cand_E: List[np.ndarray] = []
        cand_Rrel: List[np.ndarray] = []
        for ii, a in enumerate(reg):
            for b in reg[ii + 1:]:
                a_i, b_i = int(a), int(b)
                if b_i - a_i > max_span:
                    continue
                if not revisit and ((a_i, b_i) in self.pair_matches
                                    or (b_i, a_i) in self.pair_matches):
                    continue
                R_rel = self.R[b_i] @ self.R[a_i].T
                t_rel = self.t[b_i] - R_rel @ self.t[a_i]
                tn = t_rel / max(np.linalg.norm(t_rel), 1e-9)
                E = np.array([
                    [0.0, -tn[2], tn[1]],
                    [tn[2], 0.0, -tn[0]],
                    [-tn[1], tn[0], 0.0],
                ], np.float32) @ R_rel
                cand.append((a_i, b_i))
                cand_E.append(E)
                cand_Rrel.append(R_rel)
        if not cand:
            return 0

        # Batched guided matching over all candidate pairs.
        pairs = np.asarray(cand, np.int32)
        Es = np.stack(cand_E)
        xy_n = self._norm_coords_all()
        gm = guided_match_pairs(
            self._desc_d, self._valid_d, self._t(xy_n),
            pairs, Es, np.full(len(pairs), thresh_n, np.float32),
            max_matches=cfg.max_matches_per_pair,
        )
        gm_idx = gm.idx.cpu().numpy()
        gm_valid = gm.valid.cpu().numpy()
        counts = gm_valid.sum(1)
        sel = np.nonzero(counts >= cfg.min_pnp_inliers)[0]
        if len(sel) == 0:
            return 0

        # The pose-derived E is itself drifted, so its epipolar gate passes
        # wrong matches near the wrong epiline. Re-verify every candidate set
        # with its own RANSAC (batched over pairs) and require the recovered
        # rotation to agree with the current relative pose — a pair that
        # disagrees would inject the very drift it should fix.
        # Strict by design: on walked captures the candidate wide pairs
        # often see nothing in common, and their "matches" are spurious
        # plane texture — a critical surface where RANSAC happily finds
        # a wrong-but-consistent E. Loosening these gates measurably
        # degrades the ring benchmark (7.8% -> 13.2% center RMSE).
        A, B = pairs[sel, 0], pairs[sel, 1]
        xa = xy_n[A[:, None], gm_idx[sel, :, 0]]  # (S, M, 2)
        xb = xy_n[B[:, None], gm_idx[sel, :, 1]]
        # Scale-aware hypothesis budget. Small scenes: the accept gates below
        # sit on consensus COUNTS (strong/weak, 0.5*len floor), and at 512
        # hypotheses the count noise between equally-seeded runs is enough to
        # flip a drift-correcting pair in or out — the accept loop is
        # positive feedback (each accepted pair improves the map that gates
        # the next round), so one flipped gate moves the ring benchmark's
        # final drift 16% <-> 39%; 2048 hypotheses stabilize the consensus
        # maximum. At scale (>=48 images) guided matches are dense and the
        # gates sit far from their floors — 1024 measures identically and
        # halves the largest SfM phase's RANSAC share (augment was 379s of
        # the 1604s full-scale run).
        xa_d, xb_d = self._t(xa), self._t(xb)
        E2_all, inl_all = essential_ransac_pairs(
            xa_d, xb_d, self._t(gm_valid[sel], torch.bool),
            torch.full((len(sel),), 0.5 * thresh_n, device=self.device),
            num_hypotheses=2048 if self.n < 48 else 1024, generator=self.gen,
        )
        inl_all = inl_all.cpu().numpy() & gm_valid[sel]
        R2_all, _ = decompose_essential_pairs(E2_all, xa_d, xb_d,
                                              self._t(inl_all, torch.bool))
        R2_all = R2_all.cpu().numpy()

        n_pairs = 0
        n_obs = 0
        dbg = bool(os.environ.get("TPU_SPLAT_AUG_DEBUG"))
        for row, s in enumerate(sel):
            a_i, b_i = int(pairs[s, 0]), int(pairs[s, 1])
            R_rel = cand_Rrel[s]
            gidx = gm_idx[s][gm_valid[s]]
            inl = inl_all[row][gm_valid[s]]
            if inl.sum() < max(cfg.min_pnp_inliers, 0.5 * len(gidx)):
                if dbg:
                    self.log(f"aug reject ({a_i},{b_i}) span {b_i - a_i}: "
                             f"inl {int(inl.sum())}/{len(gidx)} below floor")
                continue
            dR = R2_all[row] @ R_rel.T
            ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
            # Map-agreement gate, adaptive: pairs whose own RANSAC support
            # is overwhelming get a loose gate (they are the drift-correcting
            # constraints); weakly supported candidates keep the strict 8
            # degrees (spurious plane-texture E's are internally consistent
            # but directionally random).
            strong = inl.sum() >= max(2 * cfg.min_pnp_inliers,
                                      0.7 * len(gidx))
            # The weak gate widens with pair span: a DRIFTED chain map
            # disagrees with a true span-s pair by the bend accumulated
            # over s views (~2-3 deg/view on the ring fixture), and the
            # wide pairs the gate exists to admit are exactly the ones
            # that correct that bend — a fixed 8 deg rejects them all
            # once the chain has bent enough to need them. The widening
            # stops at span 4: beyond that, genuine visual overlap is gone
            # on orbit/walk captures while repetitive-texture candidates
            # keep matching, and a wide gate admits their internally-
            # consistent-but-random E's wholesale (measured: a 20-deg gate
            # at all spans with DSP descriptors admitted 43 wide pairs and
            # tripled ring drift, 16% -> 43%) — far pairs fall back to the
            # strict 8 deg.
            span = b_i - a_i
            gate = 25.0 if strong else (
                8.0 + 2.5 * span if span <= 4 else 8.0)
            if dbg:
                self.log(f"aug cand ({a_i},{b_i}) span {span}: "
                         f"inl {int(inl.sum())}/{len(gidx)} ang {ang:.1f} "
                         f"gate {gate:.1f} strong {strong}")
            if ang > gate:
                # Overwhelming self-support but map disagreement within a
                # plausible-drift window: candidate for TRIAL admission with
                # global consensus arbitration (_trial_admit_wide_pairs) —
                # on a bent chain these are the drift correctors this gate
                # cannot distinguish from noise.
                if strong and ang <= 3.0 * gate:
                    self._aug_trial_cands.append(
                        (a_i, b_i, gidx[inl], float(ang)))
                continue
            gidx = gidx[inl]
            n_pairs += 1
            n_obs += self._merge_matches_into_tracks(a_i, b_i, gidx)
            self.pair_matches[(a_i, b_i)] = gidx
            self.pair_inliers[(a_i, b_i)] = len(gidx)
        if n_pairs:
            self.log(f"wide-pair augmentation: {n_pairs} new pairs, "
                     f"{n_obs} track links")
        return n_pairs

    def _merge_matches_into_tracks(self, a: int, b: int, idx: np.ndarray) -> int:
        """Fold (feat_a, feat_b) matches into the track graph: extend a track
        with the unseen side, merge two disjoint tracks, or start a new one."""
        n_links = 0
        n_new = 0
        for fa, fb in idx:
            fa, fb = int(fa), int(fb)
            ta = self._feat_track.get((a, fa))
            tb = self._feat_track.get((b, fb))
            if ta is None and tb is None:
                tid = len(self.tracks)
                self.tracks.append([(a, fa), (b, fb)])
                self.img_tracks[a][tid] = fa
                self.img_tracks[b][tid] = fb
                self._feat_track[(a, fa)] = tid
                self._feat_track[(b, fb)] = tid
                n_new += 1
                n_links += 1
            elif ta is None:
                if a not in {img for img, _ in self.tracks[tb]}:
                    self.tracks[tb].append((a, fa))
                    self.img_tracks[a][tb] = fa
                    self._feat_track[(a, fa)] = tb
                    n_links += 1
            elif tb is None:
                if b not in {img for img, _ in self.tracks[ta]}:
                    self.tracks[ta].append((b, fb))
                    self.img_tracks[b][ta] = fb
                    self._feat_track[(b, fb)] = ta
                    n_links += 1
            elif ta != tb:
                imgs_a = {img for img, _ in self.tracks[ta]}
                imgs_b = {img for img, _ in self.tracks[tb]}
                if imgs_a & imgs_b:
                    continue  # conflicting merge — leave both alone
                for img, feat in self.tracks[tb]:
                    self.tracks[ta].append((img, feat))
                    self.img_tracks[img].pop(tb, None)
                    self.img_tracks[img][ta] = feat
                    self._feat_track[(img, feat)] = ta
                self.tracks[tb] = []
                self.has_point[tb] = False
                n_links += 1
        if n_new:
            self.points = np.concatenate(
                [self.points, np.zeros((n_new, 3), np.float32)]
            )
            self.has_point = np.concatenate(
                [self.has_point, np.zeros(n_new, bool)]
            )
        if n_links:
            self._invalidate_obs()
        return n_links

    def _next_image(self, min_inliers: Optional[int] = None) -> Optional[int]:
        min_inliers = min_inliers or self.cfg.min_pnp_inliers
        best, best_count = None, 0
        for i in range(self.n):
            if self.registered[i] or self._attempts[i] >= 3 or not self.img_tracks[i]:
                continue
            count = sum(
                1 for tid in self.img_tracks[i] if self.has_point[tid]
            )
            if count > best_count:
                best, best_count = i, count
        if best is None or best_count < min_inliers:
            return None
        return best

    def _register_image(self, i: int, min_inliers: Optional[int] = None) -> bool:
        min_inliers = min_inliers or self.cfg.min_pnp_inliers
        # Bail only below the ratio-acceptance floor (8): an image seeing
        # 8-11 live points can still register through the high-consensus
        # path below — skipping PnP entirely for it forces the far riskier
        # relative-pose rescue.
        if sum(1 for tid in self.img_tracks[i] if self.has_point[tid]) \
                < min(min_inliers, 8):
            return False
        res = self._pnp_solve(i)
        if res is None:
            return False
        count, n_tids, R, t = res
        # Acceptance is absolute-count OR high-consensus: an image that can
        # only SEE 10-12 live points can never clear the absolute bar, but
        # 75%+ of its visible map agreeing on one pose is strong evidence
        # (COLMAP's abs_pose_min_inlier_ratio analog). Keeps sparse-map
        # registrations (self-calibration runs, low-overlap chain ends) on
        # the PnP path instead of pushing them into relative-pose rescues.
        ratio_ok = count >= max(8, -(-3 * n_tids // 4))
        if count < min_inliers and not ratio_ok:
            self.log(f"register {i}: FAILED ({count}/{n_tids} inliers)")
            return False
        self.R[i], self.t[i] = R, t
        self.registered[i] = True
        self.log(f"register {i}: {count}/{n_tids} PnP inliers")
        return True

    def _pnp_solve(self, i: int):
        """Best PnP pose of image i against the current map, WITHOUT mutating
        any mapper state. Returns (inlier_count, n_map_points, R, t), or None
        if the image sees too few live map points to pose at all."""
        with self._timed("pnp"):
            return self._pnp_solve_impl(i)

    def _pnp_solve_impl(self, i: int):
        cfg = self.cfg
        tids = [tid for tid in self.img_tracks[i] if self.has_point[tid]]
        if len(tids) < 6:
            return None
        feats = np.array([self.img_tracks[i][tid] for tid in tids])
        X = self._t(self.points[tids])
        xn = self._t(self._norm_coords(i, feats))
        vp = torch.ones(len(tids), dtype=torch.bool, device=self.device)
        thresh_n = cfg.pixel_threshold / self.fx

        # Pose seeds: the most track-connected registered cameras (annealed
        # trimmed-GN from a neighbor pose is far more noise-robust than minimal
        # DLT), plus one DLT-RANSAC estimate for the wide-baseline case.
        shared: Dict[int, int] = {}
        for tid in tids:
            for img, _ in self.tracks[tid]:
                if self.registered[img]:
                    shared[img] = shared.get(img, 0) + 1
        seeds = sorted(shared, key=shared.get, reverse=True)[:3]
        R_dlt, t_dlt, _ = pnp_ransac(X, xn, vp, thresh_n, generator=self.gen)
        # every seed refined in one batch; the first best count wins, as in
        # the reference's sequential loop
        R0 = torch.cat([self._t(self.R[seeds]).reshape(-1, 3, 3), R_dlt[None]])
        t0 = torch.cat([self._t(self.t[seeds]).reshape(-1, 3), t_dlt[None]])
        R, t, inl = pnp_refine_annealed(R0, t0, X, xn, vp, threshold=thresh_n)
        counts = inl.sum(-1)
        best = int(torch.argmax(counts))
        return (int(counts[best]), len(tids), R[best].cpu().numpy(),
                t[best].cpu().numpy())

    def _pnp_health(self) -> int:
        """Total best-PnP inlier count of all UNREGISTERED images against the
        current map. The focal-multistart discriminator: a 4-camera BA bends
        its own map to near-zero rms under any focal (so posterior rms cannot
        rank basins), but images outside the map only reproject consistently
        under the true focal — their aggregate PnP consensus peaks there."""
        cand = [
            (sum(1 for tid in self.img_tracks[i] if self.has_point[tid]), i)
            for i in range(self.n)
            if not self.registered[i] and self.img_tracks[i]
        ]
        # Cap the probe set: the 16 most map-connected images carry the
        # discriminative signal; probing all of a 150-frame capture would
        # cost hundreds of PnP solves per basin for no extra information.
        cand = sorted(i for _, i in sorted(cand, reverse=True)[:16])
        total = 0
        for i in cand:
            res = self._pnp_solve(i)
            if res is not None:
                total += res[0]
        return total

    def _next_relative_candidate(self) -> Optional[int]:
        """Unregistered image with the strongest verified pair to a registered one."""
        best, best_inl = None, 0
        for (a, b), count in self.pair_inliers.items():
            for reg, unreg in ((a, b), (b, a)):
                if self.registered[reg] and not self.registered[unreg] \
                        and self._attempts[unreg] < 3 and count > best_inl:
                    best, best_inl = unreg, count
        return best if best_inl >= self.cfg.min_pair_inliers else None

    def _register_via_relative_pose(self, i: int) -> bool:
        """Bootstrap registration from a two-view relative pose to a registered
        neighbor, with scale transferred through shared triangulated tracks.

        PnP needs length->=3 tracks; sparse match graphs can starve it even when a
        pair (registered, new) has dozens of verified two-view matches. The
        relative pose from that pair fixes R and the translation direction; the
        unknown baseline scale is the median ratio between the global depths of
        already-triangulated shared tracks and their depths in the unit-baseline
        two-view triangulation."""
        cfg = self.cfg
        thresh_n = cfg.pixel_threshold / self.fx
        # strongest verified pair with a registered image
        cand = None
        for (a, b), count in sorted(self.pair_inliers.items(),
                                    key=lambda kv: -kv[1]):
            for reg, unreg in ((a, b), (b, a)):
                if unreg == i and self.registered[reg]:
                    cand = (reg, (a, b))
                    break
            if cand:
                break
        if cand is None:
            return False
        r, key_pair = cand
        idx = self.pair_matches[key_pair]
        a, b = key_pair
        # orient match columns as (registered, new)
        feats_r = idx[:, 0] if a == r else idx[:, 1]
        feats_i = idx[:, 1] if a == r else idx[:, 0]
        xr = self._norm_coords(r, feats_r)
        xi = self._norm_coords(i, feats_i)
        E, inl_np, xr_d, xi_d = self._ransac(xr, xi, thresh_n)
        if int(inl_np.sum()) < cfg.min_pair_inliers:
            return False
        Rrel, trel = decompose_essential(E, xr_d, xi_d, self._t(inl_np, torch.bool))
        Rrel, trel = Rrel.cpu().numpy(), trel.cpu().numpy()

        # unit-baseline two-view depths in camera r
        P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
        P2 = np.concatenate([Rrel, trel[:, None]], 1).astype(np.float32)
        X_rel = triangulate_dlt(self._t(P1), self._t(P2), xr_d, xi_d).cpu().numpy()

        # scale from shared triangulated tracks
        k = self.cfg.feature.max_features
        ratios = []
        for row in range(len(feats_r)):
            if not inl_np[row]:
                continue
            # find the track of (r, feat) and check it has a global point
            tid = self._feat_track.get((r, int(feats_r[row])))
            if tid is None or not self.has_point[tid]:
                continue
            d_global = float(self.R[r][2] @ self.points[tid] + self.t[r][2])
            d_rel = float(X_rel[row, 2])
            if d_global > 1e-6 and d_rel > 1e-6:
                ratios.append(d_global / d_rel)
        # Scale-transfer evidence floor: a median over <6 depth ratios is
        # noise, and a wrong scale here compounds down the rescue chain
        # (measured: 3-4-track rescues at cams 4-6 bent the ring to 2.4
        # center RMSE). Under-evidenced images defer to the endgame
        # re-registration rounds instead.
        if len(ratios) < 6:
            return False
        s = float(np.median(ratios))
        # compose: w2c_i = [Rrel | s*trel] o w2c_r
        R_cand = (Rrel @ self.R[r]).astype(np.float32)
        t_cand = (Rrel @ self.t[r] + s * trel).astype(np.float32)
        # Validate against the MAP before committing: a rescue is a two-view
        # pose against one neighbor — if the candidate disagrees with the live
        # points it can already see, admitting it chains a warped segment into
        # the map (unvalidated 1-2-map-inlier rescues measured 2.6 center RMSE
        # on the ring scene; COLMAP never admits a camera its map disputes).
        tids = [tid for tid in self.img_tracks[i] if self.has_point[tid]]
        if len(tids) >= 4:
            feats_v = np.array([self.img_tracks[i][tid] for tid in tids])
            xn = self._norm_coords(i, feats_v)
            pc = self.points[tids] @ R_cand.T + t_cand
            z = np.maximum(pc[:, 2], 1e-9)
            err = np.where(pc[:, 2] > 1e-6,
                           np.linalg.norm(pc[:, :2] / z[:, None] - xn, axis=-1),
                           np.inf)
            med = float(np.median(err))
            # 3x the BA filter threshold: a rescue pose is pre-BA-polish, so
            # marginal disagreement is expected (and fixable); the failure
            # mode this guards is the off-by-tens-of-px garbage pose.
            if med > 3.0 * self.cfg.max_reproj_error_px / self.fx:
                self.log(f"register {i}: rescue to {r} rejected "
                         f"(median map err {med * self.fx:.1f}px)")
                return False
        self.R[i] = R_cand
        self.t[i] = t_cand
        self.registered[i] = True
        self.log(f"register {i}: via relative pose to {r} "
                 f"(scale from {len(ratios)} shared tracks)")
        return True

    def _triangulate_image_tracks(self, img_ids: List[int]):
        """(Re)triangulate tracks observed by the given images using all
        registered observations (batched multi-view DLT). Candidate
        selection, the (track, view) table build, and acceptance all run as
        flat numpy passes over the observation mirror — the per-observation
        Python version of this function dominated full-scale runs (a
        retriangulation follows every BA round)."""
        with self._timed("triangulate"):
            self._triangulate_image_tracks_impl(img_ids)

    def _triangulate_image_tracks_impl(self, img_ids: List[int]):
        cfg = self.cfg
        oi, of, ot = self._flat_obs()
        n_tracks = len(self.tracks)
        touched = np.zeros(n_tracks, bool)
        img_sel = np.zeros(self.n, bool)
        img_sel[np.asarray(img_ids, np.int64)] = True
        touched[ot[img_sel[oi]]] = True
        reg_obs = self.registered[oi]
        reg_count = np.bincount(ot[reg_obs], minlength=n_tracks)
        cand_mask = touched & (reg_count >= 2)
        cand_mask[np.nonzero(self.has_point)[0]] = False
        if not cand_mask.any():
            return
        # registered observations of candidate tracks, grouped by track in
        # track-list order (the mirror's order invariant), first 8 per track
        sel = np.nonzero(cand_mask[ot] & reg_obs)[0]
        order = np.argsort(ot[sel], kind="stable")
        sel = sel[order]
        ts = ot[sel]
        first = np.empty(len(ts), bool)
        first[0] = True
        first[1:] = ts[1:] != ts[:-1]
        row = np.cumsum(first) - 1
        starts = np.nonzero(first)[0]
        col = np.arange(len(ts)) - starts[row]
        max_views = 8
        keep = col < max_views
        sel, row, col, ts = sel[keep], row[keep], col[keep], ts[keep]
        cand = np.unique(ts)  # row r <-> track cand[r]
        n_cand = len(cand)
        Ps = np.zeros((n_cand, max_views, 3, 4), np.float32)
        xs = np.zeros((n_cand, max_views, 2), np.float32)
        vs = np.zeros((n_cand, max_views), bool)
        imgs_o, feats_o = oi[sel], of[sel]
        Ps[row, col, :, :3] = self.R[imgs_o]
        Ps[row, col, :, 3] = self.t[imgs_o]
        xs[row, col] = self._norm_coords_batch(imgs_o, feats_o)
        vs[row, col] = True
        X = triangulate_multiview(self._t(Ps), self._t(xs),
                                  self._t(vs, torch.bool)).cpu().numpy()
        # acceptance: in front of all views, small reprojection error, parallax
        max_err_n = cfg.max_reproj_error_px / self.fx
        pc = np.einsum("nij,nj->ni", self.R[imgs_o], X[row]) + self.t[imgs_o]
        front = pc[:, 2] > 1e-6
        z = np.where(front, pc[:, 2], 1.0)
        err = np.linalg.norm(pc[:, :2] / z[:, None] - xs[row, col], axis=1)
        ok = np.ones(n_cand, bool)
        np.logical_and.at(ok, row, front)
        max_err = np.zeros(n_cand, np.float32)
        np.maximum.at(max_err, row, np.where(front, err, 0.0).astype(np.float32))
        ok &= max_err <= max_err_n
        # parallax between the FIRST and LAST used view of each row
        # (observations are contiguous per row after the stable sort)
        centers = -np.einsum("nji,nj->ni", self.R[imgs_o], self.t[imgs_o])
        _, first_idx, nviews = np.unique(row, return_index=True,
                                         return_counts=True)
        last_idx = first_idx + nviews - 1
        Xr = X
        d1 = Xr - centers[first_idx]
        d2 = Xr - centers[last_idx]
        denom = np.maximum(
            np.linalg.norm(d1, axis=1) * np.linalg.norm(d2, axis=1), 1e-12)
        cosang = np.clip(np.sum(d1 * d2, axis=1) / denom, -1.0, 1.0)
        ang = np.degrees(np.arccos(cosang))
        ok &= (nviews < 2) | (ang >= cfg.min_triangulation_angle_deg)
        acc = cand[ok]
        self.points[acc] = Xr[ok]
        self.has_point[acc] = True

    def _ba_problem(self, cam_ids, live, obs_cam, obs_pt, obs_uv) -> BAProblem:
        return BAProblem(
            cam_rotmats=self._t(self.R[cam_ids]),
            cam_trans=self._t(self.t[cam_ids]),
            points=self._t(self.points[live]),
            obs_cam=self._t(obs_cam, torch.long),
            obs_pt=self._t(obs_pt, torch.long),
            obs_uv=self._t(obs_uv),
            obs_valid=torch.ones(len(obs_cam), dtype=torch.bool, device=self.device),
        )

    def _gather_observations(self):
        """Flatten (registered-image, live-track) observations into BA arrays
        (one vectorized pass over the observation mirror; BA is order-
        independent — it segment-sums by camera/point id)."""
        cam_ids = np.nonzero(self.registered)[0]
        live = np.nonzero(self.has_point)[0]
        cam_map = np.full(self.n, -1, np.int32)
        cam_map[cam_ids] = np.arange(len(cam_ids), dtype=np.int32)
        pt_map = np.full(len(self.has_point), -1, np.int32)
        pt_map[live] = np.arange(len(live), dtype=np.int32)
        oi, of, ot = self._flat_obs()
        sel = self.registered[oi] & self.has_point[ot]
        oi, of, ot = oi[sel], of[sel], ot[sel]
        return (cam_ids, live, cam_map[oi], pt_map[ot],
                self._norm_coords_batch(oi, of))

    def _bundle_adjust(self, extended: bool = False,
                       force_focal: bool = False,
                       refine_k1: bool = False,
                       cg_scale: int = 1) -> Optional[float]:
        """One BA round over the current map. Returns the posterior
        reprojection rms in pixels (None if the map is too small to adjust).

        cg_scale deepens the CG chain per outer iteration WITHOUT adding
        outer rounds: the Jacobi preconditioner is local, so the global
        low-curvature modes of an open camera chain (the bend that shows up
        as end-to-end drift) are the slowest CG directions — they need long
        chains, and restarting CG each outer round resets their progress.
        Used by the final convergence polish only."""
        with self._timed("ba_ext" if extended else "ba"):
            return self._bundle_adjust_impl(extended, force_focal, refine_k1,
                                            cg_scale)

    def _bundle_adjust_impl(self, extended: bool = False,
                            force_focal: bool = False,
                            refine_k1: bool = False,
                            cg_scale: int = 1) -> Optional[float]:
        if self.registered.sum() < 2 or self.has_point.sum() < 8:
            return None
        self._last_ba_reg = int(self.registered.sum())
        cfg = self.cfg
        cam_ids, live, obs_cam, obs_pt, obs_uv = self._gather_observations()
        o = len(obs_cam)
        problem = self._ba_problem(cam_ids, live, obs_cam, obs_pt, obs_uv)
        # Focal refinement is frozen during early map growth: small partial-
        # scene BAs (few cams, short tracks) are too poorly conditioned —
        # refining focal there oscillates it +-20% and destabilizes
        # registration. From 8 registered cameras on, the (clamped, <=5% per
        # outer round) shared-focal parameter turns on so that LATER
        # registrations already run with a corrected focal — waiting for the
        # final extended BAs lets a bad prior fail mid-mapping PnPs and warp
        # the map through relative-pose rescues before focal ever corrects.
        # In-place focal refinement only runs AFTER the multistart basin
        # search has made the first focal decision (and kept the prior —
        # a restart sets calibrate=False): refining in place from a wrong
        # prior converges to the warped-map attractor the search exists to
        # avoid. force_focal is the search's own trial path.
        refine_focal = self.calibrate and (
            force_focal
            or (self._focal_refined_once
                and (extended or len(cam_ids) >= 8)))
        # Radial k1 is never estimated here on the mapper's own initiative:
        # only _refine_distortion_endgame passes refine_k1=True, on the
        # CONVERGED map, and keeps the result only if it decisively beats the
        # pinhole model. Mid-growth joint (f, k1) estimation is poisonous on
        # low-elevation orbits — k1 absorbs residual focal error along the
        # near-degenerate (f, k1) ridge and warps the map while the
        # reprojection rms *improves* (measured: a pinhole ring drifted to
        # k1=-0.05 and doubled its camera-center RMSE).
        R, t, X, rms, fscale, dk1 = bundle_adjust(
            problem,
            huber_delta=cfg.pixel_threshold / self.fx,
            outer_iters=cfg.ba_outer_iters * (3 if extended else 1),
            cg_iters=cfg.ba_cg_iters * (2 if extended else 1) * cg_scale,
            optimize_focal=refine_focal,
            optimize_k1=refine_k1,
        )
        self.R[cam_ids] = R.cpu().numpy()
        self.t[cam_ids] = t.cpu().numpy()
        self.points[live] = X.cpu().numpy()
        if refine_focal:
            s = float(fscale)
            if abs(s - 1.0) > 1e-5:
                self.fx *= s
                self.fy *= s
            if abs(s - 1.0) > 0.02:
                # Focal moved materially: drops made under the old focal are
                # stale — re-test the quarantine so map density recovers.
                self._readmit_observations()
            if not self._focal_refined_once:
                # Images deferred (PnP-failed) under the raw prior get fresh
                # attempts now that focal is corrected (see the run loop).
                self._focal_refined_once = True
                self._attempts[~self.registered] = 0
        if refine_k1:
            step = float(dk1)
            if abs(step) > 1e-6:
                # BA saw obs undistorted with the OLD k1, so the delta is the
                # residual distortion — accumulate (exact under BA-round
                # iteration; each later round re-undistorts with the update).
                self.k1 += step
            if abs(step) > 0.005:
                # distortion moved materially: border-region drops made under
                # the old model are stale, same readmission logic as focal
                self._readmit_observations()
        rms_px = float(rms) * self.fx
        self.log(
            f"BA: {len(cam_ids)} cams, {len(live)} pts, {o} obs, "
            f"rms {rms_px:.2f}px"
            + (f", focal x{float(fscale):.4f} -> {self.fx:.1f}"
               if refine_focal else "")
            + (f", k1 {self.k1:+.4f}" if refine_k1 else "")
        )
        return rms_px

    def _refine_focal_multistart(self):
        """Search focal basins by BA when the mapper stalls early while
        self-calibrating.

        The shared-focal BA parameter is locally convergent only: started from
        a 30-40% wrong prior it settles in a warped-map local optimum (the map
        bends to stay consistent with the wrong focal, COLMAP shows the same
        failure on degenerate captures). Re-run BA from the CURRENT geometry
        under a grid of focal bases and keep the basin under which the
        UNREGISTERED images PnP-register best (`_pnp_health`) — posterior rms
        cannot rank basins because a tiny BA bends its map to ~1px under any
        focal, but out-of-map images only reproject consistently under the
        true one. Map consistency discriminates focal where two-view consensus
        (`_calibrate_focal`) is flat."""
        saved = (self.fx, self.fy, self.R.copy(), self.t.copy(),
                 self.points.copy(), self.has_point.copy())
        fx0, fy0 = self.fx, self.fy
        results = []  # (health, rms_px, fx, fy)
        trace = []
        for s in (0.6, 0.75, 0.9, 1.0, 1.2):
            self.fx, self.fy = fx0 * s, fy0 * s
            self.R, self.t = saved[2].copy(), saved[3].copy()
            self.points, self.has_point = saved[4].copy(), saved[5].copy()
            rms = self._bundle_adjust(force_focal=True)
            if rms is None:
                continue
            # Retriangulate before scoring: a stalled map can be too sparse
            # for out-of-map images to see >= 6 live points, so health would
            # be noise-flat without it — and triangulation itself
            # discriminates (the true focal passes more tracks through the
            # reprojection and angle gates, feeding more PnP consensus).
            self._retriangulate()
            health = self._pnp_health()
            results.append((health, rms, self.fx, self.fy))
            trace.append(f"{self.fx:.0f}:h{health}/r{rms:.2f}px")
        (self.fx, self.fy, self.R, self.t,
         self.points, self.has_point) = saved
        if not results:
            return
        # Selection: PnP health of out-of-map images first (immune to the
        # small-map bend-to-fit failure), posterior rms as the tie-break.
        # The tie-break regime depends on signal strength: on a tiny stalled
        # map (aggregate health < 30) a 1-2 inlier health edge IS the signal
        # and rms actively lies (a 4-cam map bends to sub-px rms under any
        # focal — measured r1.16px at the WORST basin), so demand the strict
        # health max; on a mature map health saturates (every image registers
        # under every basin) while the true basin's rms is measurably lower
        # (0.6 vs 0.9px on the ring), so there a 10% health band + min rms
        # decides.
        hmax = max(r[0] for r in results)
        if hmax >= 30:
            band = [r for r in results if r[0] >= 0.9 * hmax]
        else:
            band = [r for r in results if r[0] == hmax]
        best = min(band, key=lambda r: r[1])
        self.log(f"focal multistart: {{{', '.join(trace)}}} "
                 f"-> fx={best[2]:.1f} (prior {fx0:.1f})")
        if abs(best[2] / fx0 - 1.0) <= 0.03:
            # The prior basin won: the current map was grown under (nearly)
            # the chosen focal, so keep growing it in place.
            self._focal_refined_once = True
            return
        # Do NOT continue growing this map: it was bootstrapped under the
        # wrong prior and keeps a baked-in warp through any amount of BA
        # (measured 2.7 center RMSE with healthy registrations); request a
        # from-scratch regrowth under the calibrated focal instead.
        raise _RestartWithFocal(best[2])

    def _filter_points(self):
        """Drop observations/points with high reprojection error or behind cameras."""
        max_err_n = self.cfg.max_reproj_error_px / self.fx
        live = np.nonzero(self.has_point)[0]
        for tid in live:
            errs = []
            for img, feat in self.tracks[tid]:
                if not self.registered[img]:
                    continue
                pc = self.R[img] @ self.points[tid] + self.t[img]
                if pc[2] <= 1e-6:
                    errs.append(np.inf)
                    continue
                errs.append(
                    np.linalg.norm(
                        pc[:2] / pc[2] - self._norm_coords(img, np.array([feat]))[0]
                    )
                )
            if not errs or np.median(errs) > max_err_n:
                self.has_point[tid] = False
        # Robust spatial outlier filter: low-parallax junk passes reprojection
        # checks but lands absurdly far away; drop points beyond 5x the 90th
        # percentile distance from the robust scene center.
        live = np.nonzero(self.has_point)[0]
        if len(live) > 20:
            pts = self.points[live]
            center = np.median(pts, axis=0)
            dist = np.linalg.norm(pts - center, axis=1)
            limit = 3.0 * max(np.percentile(dist, 80), 1e-6)
            far = dist > limit
            if far.any():
                self.has_point[live[far]] = False
                self.log(f"filter: dropped {int(far.sum())} far outlier points")

    def export_colmap_database(self, path: str,
                               image_names: Optional[List[str]] = None):
        """Write this mapper's features + verified matches as a COLMAP
        database.db (colmap_db.write_database), so stock COLMAP tooling can
        inspect or continue from them. Feature arrays are exported unfiltered
        (padded rows included) so match indices stay valid; the verified pair
        sets land in both `matches` and `two_view_geometries`."""
        from tpu_splat_torch.sfm.colmap_db import write_database

        names = image_names or [f"frame_{i:04d}.png" for i in range(self.n)]
        write_database(
            path, self.w, self.h, self.fx, self.fy, self.cx, self.cy,
            names,
            keypoints=[np.asarray(f.xy) for f in self.feats],
            descriptors=[np.asarray(f.descriptor) for f in self.feats],
            scales=[np.asarray(f.scale) for f in self.feats],
            orientations=[np.asarray(f.orientation) for f in self.feats],
            matches=self.pair_matches,
            verified=self.pair_matches,
            k1=self.k1,
        )

    def _to_scene(self) -> SfMScene:
        live = np.nonzero(self.has_point)[0]
        pts = self.points[live]
        # colors: sample the first registered observation of each track
        colors = np.zeros((len(live), 3), np.float32)
        errors = np.zeros(len(live), np.float32)
        counts = np.zeros(len(live), np.int32)
        for row, tid in enumerate(live):
            for img, feat in self.tracks[tid]:
                if not self.registered[img]:
                    continue
                x, y = self.feats[img].xy[feat]
                xi = int(np.clip(round(x), 0, self.w - 1))
                yi = int(np.clip(round(y), 0, self.h - 1))
                im = self.images[img]
                colors[row] = im[yi, xi] if im.ndim == 3 else np.repeat(im[yi, xi], 3)
                break
            counts[row] = sum(self.registered[img] for img, _ in self.tracks[tid])

        cam_ids = np.nonzero(self.registered)[0]
        w2c = np.tile(np.eye(4, dtype=np.float32), (len(cam_ids), 1, 1))
        w2c[:, :3, :3] = self.R[cam_ids]
        w2c[:, :3, 3] = self.t[cam_ids]
        c2w = np.linalg.inv(w2c)
        fx_arr = np.full((len(cam_ids),), self.fx, np.float32)
        fy_arr = np.full((len(cam_ids),), self.fy, np.float32)
        cx_arr = np.full((len(cam_ids),), self.cx, np.float32)
        cy_arr = np.full((len(cam_ids),), self.cy, np.float32)
        if self.percam_fscale is not None:
            # endgame per-camera polish (cfg.refine_per_camera): corrections
            # live in normalized units -> pixels via the shared focal
            s = self.percam_fscale[cam_ids]
            fx_arr *= s
            fy_arr *= s
            cx_arr += self.percam_pp[cam_ids, 0] * self.fx
            cy_arr += self.percam_pp[cam_ids, 1] * self.fy
        cams = Cameras(
            camtoworlds=c2w.astype(np.float32),
            fx=fx_arr,
            fy=fy_arr,
            cx=cx_arr,
            cy=cy_arr,
            # Self-calibrated shared radial term. The poses/points above live
            # in UNDISTORTED observation space (see _norm_coords), so this
            # records the distortion of the ORIGINAL images — consumers must
            # undistort the images (sfm/undistort.py) before pinhole use;
            # the runner does so right after SfM.
            distortion=np.tile(
                np.array([[self.k1, 0.0, 0.0, 0.0]], np.float32),
                (len(cam_ids), 1)),
            width=self.w,
            height=self.h,
        )
        self.cam_ids = cam_ids
        return SfMScene(
            cameras=cams,
            points=pts,
            point_colors=colors,
            point_errors=errors,
            track_counts=counts,
            registered=self.registered.copy(),
        )


def run_sfm(
    images: np.ndarray,
    cfg: Optional[MapperConfig] = None,
    fx: Optional[float] = None,
    fy: Optional[float] = None,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    log_fn=None,
    colmap_database: Optional[str] = None,
    export_database: Optional[str] = None,
    device=None,
) -> SfMScene:
    """images (N, H, W[, 3]) float in [0,1] -> SfMScene (poses + sparse points),
    every phase on `device` (CUDA unless the CPU is asked for).

    With `colmap_database`, features and verified matches are loaded from an
    existing COLMAP database.db (sfm/colmap_db.py) instead of being computed:
    the hand-off point for users of COLMAP-based SfM. Intrinsics default to
    the DB's camera when not given. With `export_database`, the mapper's
    final features and verified matches are written to a database.db.

    SfM runs in full f32: `resolve_device` turns TF32 off on CUDA (in the
    reference, bf16 matmul passes lose most registrations)."""
    cfg = cfg or MapperConfig()
    if colmap_database is not None:
        m = _mapper_from_database(images, cfg, colmap_database, fx, fy, cx, cy, log_fn,
                                  device)
    else:
        m = IncrementalMapper(images, cfg, fx=fx, fy=fy, cx=cx, cy=cy, log_fn=log_fn,
                              device=device)
        m.extract_all()
        m.match_all()
    m.build_tracks()
    scene = m.reconstruct()
    m._log_timers("done")
    if export_database is not None:
        # post-reconstruct: a focal-multistart restart rebuilds matches,
        # so the exported DB reflects the FINAL intrinsics' match sets
        m.export_colmap_database(export_database)
    return scene


def _mapper_from_database(images, cfg, db_path, fx, fy, cx, cy, log_fn, device=None):
    """Seed an IncrementalMapper from a COLMAP database.db: keypoints +
    descriptors become the feature sets (u8 descriptors renormalized to the
    unit-norm f32 convention), two_view_geometries (falling back to raw
    matches) become the verified pair sets. Image order follows the DB's
    image_id order, which must match the order of `images`."""
    from dataclasses import replace

    from tpu_splat_torch.sfm.colmap_db import read_database

    db = read_database(db_path)
    cam = db["cameras"].get(1) or next(iter(db["cameras"].values()))
    p = cam["params"]
    model = cam["model"]
    if fx is None and cam is not None:
        if model in (0, 2):  # SIMPLE_PINHOLE / SIMPLE_RADIAL
            fx = fy = float(p[0])
            cx, cy = float(p[1]), float(p[2])
        elif model == 1:  # PINHOLE
            fx, fy = float(p[0]), float(p[1])
            cx, cy = float(p[2]), float(p[3])
    # build_tracks strides the union-find by max_features — it must bound the
    # DB's per-image keypoint counts
    max_k = max((len(kp) for kp in db["keypoints"].values()), default=0)
    if max_k > cfg.feature.max_features:
        cfg = replace(cfg, feature=replace(cfg.feature, max_features=max_k))
    m = IncrementalMapper(images, cfg, fx=fx, fy=fy, cx=cx, cy=cy,
                          log_fn=log_fn, device=device)
    n = len(images)
    feats = []
    for i in range(n):
        kp = db["keypoints"].get(i + 1)
        if kp is None:
            raise ValueError(f"database has no keypoints for image_id {i + 1}")
        k = len(kp)
        desc = db["descriptors"].get(i + 1)
        if desc is not None:
            d = desc.astype(np.float32) / 512.0
            d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
        else:
            d = np.zeros((k, 128), np.float32)
        # scale/orientation from the affine columns when present (6-col form)
        if kp.shape[1] >= 6:
            scale = np.sqrt(np.maximum(
                kp[:, 2] * kp[:, 5] - kp[:, 3] * kp[:, 4], 1e-12))
            orient = np.arctan2(kp[:, 4], kp[:, 2])
        elif kp.shape[1] >= 4:
            scale, orient = kp[:, 2], kp[:, 3]
        else:
            scale = np.ones(k, np.float32)
            orient = np.zeros(k, np.float32)
        feats.append(Features(
            xy=np.asarray(kp[:, :2], np.float32),
            scale=np.asarray(scale, np.float32),
            orientation=np.asarray(orient, np.float32),
            response=np.ones((k,), np.float32),
            descriptor=np.asarray(d, np.float32),
            valid=np.ones((k,), bool),
        ))
    m.feats = feats
    # the device copies extraction would leave, padded with invalid rows to
    # the largest keypoint count (a COLMAP database's counts differ)
    k_max = max(len(f.xy) for f in feats)
    desc = np.zeros((n, k_max, 128), np.float32)
    valid = np.zeros((n, k_max), bool)
    for i, f in enumerate(feats):
        desc[i, :len(f.xy)] = f.descriptor
        valid[i, :len(f.xy)] = True
    m._desc_d, m._valid_d = m._t(desc), m._t(valid, torch.bool)
    source = db["two_view"] or db["matches"]
    m.pair_matches = {}
    m.pair_inliers = {}
    for (a, b), idx in source.items():
        if a < n and b < n and len(idx) >= cfg.min_pair_inliers:
            m.pair_matches[(a, b)] = np.asarray(idx, np.int64)
            m.pair_inliers[(a, b)] = len(idx)
    if m.log:
        m.log(f"colmap db: {len(feats)} feature sets, "
              f"{len(m.pair_matches)} verified pairs loaded")
    if model == 2 and len(p) >= 4 and abs(float(p[3])) > 1e-8:
        m.k1 = float(p[3])  # DB's SIMPLE_RADIAL k1: _norm_coords undistorts
    return m

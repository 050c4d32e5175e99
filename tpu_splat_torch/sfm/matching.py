"""Feature matching and pair-selection policies (the port of
tpu_splat/sfm/matching.py).

Matching is one descriptor product per pair (descriptors are L2-normalised,
so dot-product ranking is L2 ranking) with Lowe's ratio test and a mutual
nearest-neighbour check, all fixed-shape and batched over pairs. The
products stay full f32: `core.device.resolve_device` turns TF32 off.

Pair policies (numpy, as in the reference): exhaustive, sequential (window +
power-of-2 loop-closure links), spatial (k nearest position priors, else
retrieval) and vocab/retrieval (mean-pooled global descriptor similarity).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

NEG_INF = float("-inf")


class Matches(NamedTuple):
    idx: torch.Tensor  # (..., M, 2) int64 indices into features of image a / image b
    valid: torch.Tensor  # (..., M) bool


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: descending, ties by lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _best_two(sim: torch.Tensor):
    """Row maximum, its first index and the masked second maximum of
    (..., Ka, Kb) similarities (two max reductions, not a per-row sort)."""
    m1 = sim.amax(-1)
    best_b = torch.argmax(sim, dim=-1)
    cols = torch.arange(sim.shape[-1], device=sim.device)
    m2 = torch.where(cols == best_b[..., None], NEG_INF, sim).amax(-1)
    return m1, best_b, m2


def _mutual_top(sim, m1, best_b, ok, max_matches):
    """Keep rows that are their column's best too, ranked by similarity."""
    best_a_of_b = torch.argmax(sim, dim=-2)  # (..., Kb)
    rows = torch.arange(sim.shape[-2], device=sim.device)
    mutual = torch.gather(best_a_of_b, -1, best_b) == rows
    score = torch.where(ok & mutual, m1, NEG_INF)
    top_scores, sel_a = _top_k(score, min(max_matches, score.shape[-1]))
    pairs = torch.stack([sel_a, torch.gather(best_b, -1, sel_a)], dim=-1)
    return Matches(idx=pairs, valid=torch.isfinite(top_scores))


def _dist(m: torch.Tensor) -> torch.Tensor:
    """L2 distance of unit vectors from their cosine similarity."""
    return torch.sqrt(torch.clamp_min(2.0 - 2.0 * m, 0.0))


def match_descriptors(desc_a: torch.Tensor, valid_a: torch.Tensor, desc_b: torch.Tensor,
                      valid_b: torch.Tensor, ratio: float = 0.8,
                      max_matches: int = 2048) -> Matches:
    """Mutual-nearest-neighbour matching with Lowe's ratio test.

    desc_*: (..., K, 128) L2-normalised, valid_*: (..., K). Returns up to
    max_matches pairs sorted by similarity."""
    sim = desc_a @ desc_b.mT
    sim = torch.where(valid_a[..., :, None] & valid_b[..., None, :], sim, NEG_INF)
    m1, best_b, m2 = _best_two(sim)
    ok = (_dist(m1) < ratio * _dist(m2)) & valid_a & (m1 > NEG_INF)
    return _mutual_top(sim, m1, best_b, ok, max_matches)


def match_descriptors_pairs(desc: torch.Tensor, valid: torch.Tensor, pairs: np.ndarray,
                            ratio: float = 0.8, max_matches: int = 2048,
                            chunk: int = 16) -> Matches:
    """Batched pair matching: desc (N, K, 128), valid (N, K), pairs (P, 2) ->
    Matches with a leading pair axis, `chunk` pairs per pass (bounding the
    (chunk, K, K) similarity tensor)."""
    pairs_t = torch.as_tensor(np.asarray(pairs), dtype=torch.long, device=desc.device)
    outs = []
    for i in range(0, len(pairs_t), chunk):
        a, b = pairs_t[i:i + chunk, 0], pairs_t[i:i + chunk, 1]
        outs.append(match_descriptors(desc[a], valid[a], desc[b], valid[b], ratio=ratio,
                                      max_matches=max_matches))
    return Matches(*(torch.cat(parts) for parts in zip(*outs)))


def guided_match(desc_a: torch.Tensor, valid_a: torch.Tensor, xy_a_n: torch.Tensor,
                 desc_b: torch.Tensor, valid_b: torch.Tensor, xy_b_n: torch.Tensor,
                 E: torch.Tensor, epipolar_threshold, min_similarity: float = 0.8,
                 max_matches: int = 2048) -> Matches:
    """Epipolar-guided re-matching (COLMAP's guided matching analog).

    Candidates are descriptor pairs that are similar enough and
    Sampson-consistent with E (..., 3, 3); a ratio test (0.9) within the
    gated candidates and a mutual check pick the matches. xy_*_n: (..., K, 2)
    normalised coords; epipolar_threshold: a float or a (...,) tensor."""
    sim = desc_a @ desc_b.mT
    p1 = torch.cat([xy_a_n, torch.ones_like(xy_a_n[..., :1])], dim=-1)
    p2 = torch.cat([xy_b_n, torch.ones_like(xy_b_n[..., :1])], dim=-1)
    Ep1 = p1 @ E.mT
    Etp2 = p2 @ E
    num = (Ep1 @ p2.mT) ** 2
    den = ((Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2)[..., :, None]
           + (Etp2[..., 0] ** 2 + Etp2[..., 1] ** 2)[..., None, :])
    sampson = num / torch.clamp_min(den, 1e-12)
    thr = torch.as_tensor(epipolar_threshold, dtype=sim.dtype, device=sim.device)
    thr2 = (thr ** 2).reshape(thr.shape + (1, 1))
    ok = ((sampson < thr2) & (sim > min_similarity)
          & valid_a[..., :, None] & valid_b[..., None, :])
    gated = torch.where(ok, sim, NEG_INF)
    best_sim, best_b, second = _best_two(gated)
    ratio_ok = torch.where(torch.isfinite(second), _dist(best_sim) < 0.9 * _dist(second),
                           True)
    return _mutual_top(gated, best_sim, best_b, ratio_ok & torch.isfinite(best_sim),
                       max_matches)


def guided_match_pairs(desc: torch.Tensor, valid: torch.Tensor, xy_n: torch.Tensor,
                       pairs: np.ndarray, Es: torch.Tensor, epipolar_thresholds: torch.Tensor,
                       max_matches: int = 2048, chunk: int = 16) -> Matches:
    """Batched guided re-matching: desc (N, K, 128), valid (N, K), xy_n
    (N, K, 2) normalised coords, pairs (P, 2), Es (P, 3, 3), thresholds (P,);
    `chunk` pairs per pass."""
    pairs_t = torch.as_tensor(np.asarray(pairs), dtype=torch.long, device=desc.device)
    Es = torch.as_tensor(Es, dtype=desc.dtype, device=desc.device)
    thr = torch.as_tensor(epipolar_thresholds, dtype=desc.dtype, device=desc.device)
    outs = []
    for i in range(0, len(pairs_t), chunk):
        a, b = pairs_t[i:i + chunk, 0], pairs_t[i:i + chunk, 1]
        outs.append(guided_match(desc[a], valid[a], xy_n[a], desc[b], valid[b], xy_n[b],
                                 Es[i:i + chunk], thr[i:i + chunk], max_matches=max_matches))
    return Matches(*(torch.cat(parts) for parts in zip(*outs)))


def sequential_pairs(n: int, overlap: int = 10, loop_closure: bool = True) -> np.ndarray:
    """COLMAP sequential-matcher pair list: window + power-of-2 links."""
    pairs = set()
    for i in range(n):
        for d in range(1, overlap + 1):
            if i + d < n:
                pairs.add((i, i + d))
        if loop_closure:
            d = overlap * 2
            while i + d < n:
                pairs.add((i, i + d))
                d *= 2
    return np.array(sorted(pairs), dtype=np.int32).reshape(-1, 2)


def exhaustive_pairs(n: int) -> np.ndarray:
    return np.array(
        [(i, j) for i in range(n) for j in range(i + 1, n)], dtype=np.int32
    ).reshape(-1, 2)


def retrieval_pairs(descriptors: np.ndarray, valids: np.ndarray, k: int = 10) -> np.ndarray:
    """Vocab-tree analog: rank pairs by global-descriptor similarity.

    descriptors: (N, K, 128); valids: (N, K). Global descriptor = mean of local
    descriptors (a simple but effective VLAD-lite retrieval signal)."""
    n = descriptors.shape[0]
    w = valids[..., None].astype(np.float32)
    g = (descriptors * w).sum(1) / np.maximum(w.sum(1), 1.0)
    g = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-8)
    sim = g @ g.T
    np.fill_diagonal(sim, -np.inf)
    pairs = set()
    for i in range(n):
        for j in np.argsort(-sim[i])[:k]:
            a, b = min(i, int(j)), max(i, int(j))
            pairs.add((a, b))
    return np.array(sorted(pairs), dtype=np.int32).reshape(-1, 2)


def spatial_pairs(positions: Optional[np.ndarray], n: int, k: int = 10,
                  descriptors: Optional[np.ndarray] = None,
                  valids: Optional[np.ndarray] = None) -> np.ndarray:
    """Spatial matcher: k-nearest by position prior; retrieval fallback."""
    if positions is None:
        if descriptors is not None:
            return retrieval_pairs(descriptors, valids, k=k)
        return sequential_pairs(n)
    pairs = set()
    for i in range(n):
        d = np.linalg.norm(positions - positions[i], axis=-1)
        d[i] = np.inf
        for j in np.argsort(d)[:k]:
            a, b = min(i, int(j)), max(i, int(j))
            pairs.add((a, b))
    return np.array(sorted(pairs), dtype=np.int32).reshape(-1, 2)


def select_pairs(
    method: str,
    n: int,
    exhaustive_max_images: int = 20,
    positions: Optional[np.ndarray] = None,
    descriptors: Optional[np.ndarray] = None,
    valids: Optional[np.ndarray] = None,
    overlap: int = 10,
    k: int = 10,
) -> np.ndarray:
    """Pair policy dispatch with the reference's small-set exhaustive override."""
    if n <= exhaustive_max_images:
        return exhaustive_pairs(n)
    if method == "exhaustive":
        return exhaustive_pairs(n)
    if method == "sequential":
        return sequential_pairs(n, overlap=overlap)
    if method == "spatial":
        return spatial_pairs(positions, n, k=k, descriptors=descriptors, valids=valids)
    if method in ("vocab", "vocab_tree", "retrieval"):
        if descriptors is None:
            return sequential_pairs(n, overlap=overlap)
        return retrieval_pairs(descriptors, valids, k=k)
    raise ValueError(f"unknown matching method {method!r}")

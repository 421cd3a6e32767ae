"""Phase-aware Topology Construction Algorithm (paper Alg. 3).

Phase 1 (t <= t_thre): pair dissimilar data (EMD, Eq. 45) weighted against
physical distance (priority p1, Eq. 46) — the activated worker's aggregation
neighborhood approximates an IID sample.
Phase 2: diversity (fewer historical pulls) x staleness-gap control
(priority p2, Eq. 47).

The greedy loop respects per-worker bandwidth budgets on BOTH endpoints
(pulling consumes the puller's and the pushed worker's bandwidth, Eq. 10) and
terminates when total consumption stops growing (Alg. 3 lines 18-21).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


def emd_matrix(class_counts: np.ndarray) -> np.ndarray:
    """Eq. (45): pairwise Earth-Mover's distance between label histograms.

    class_counts: (N, n_classes) sample counts per worker."""
    dist = class_counts / np.maximum(class_counts.sum(axis=1, keepdims=True), 1)
    return np.abs(dist[:, None, :] - dist[None, :, :]).sum(axis=-1)


def priority_phase1(emd: np.ndarray, phys_dist: np.ndarray) -> np.ndarray:
    """Eq. (46): p1(i,j) = EMD/EMD_max + (1 - Dist/Dist_max)."""
    emd_max = max(emd.max(), 1e-12)
    d_max = max(phys_dist.max(), 1e-12)
    return emd / emd_max + (1.0 - phys_dist / d_max)


def priority_phase2(pull_counts: np.ndarray, tau: np.ndarray, t: int,
                    rows: Optional[np.ndarray] = None) -> np.ndarray:
    """Eq. (47): p2(i,j) = (1 - Pull(i,j)/t) * 1/(1+|tau_i - tau_j|).

    With ``rows`` (int indices), only those rows are evaluated (the rest is
    0) — the greedy construction reads priority for ACTIVE pullers alone, so
    the per-round hot path computes O(k·N) instead of O(N²); values on the
    evaluated rows are bitwise-equal to the dense form.
    """
    t = max(t, 1)
    if rows is None:
        gap = np.abs(tau[:, None] - tau[None, :]).astype(np.float64)
        return (1.0 - pull_counts / t) / (1.0 + gap)
    prio = np.zeros(pull_counts.shape, np.float64)
    gap = np.abs(tau[rows, None] - tau[None, :]).astype(np.float64)
    prio[rows] = (1.0 - pull_counts[rows] / t) / (1.0 + gap)
    return prio


@dataclasses.dataclass
class PTCAResult:
    links: np.ndarray            # (N, N) bool; links[i, j] = i pulls from j
    bandwidth_used: np.ndarray   # (N,) units of b consumed per worker


def construct_topology(
    active: np.ndarray,               # (N,) bool
    in_range: np.ndarray,             # (N, N) bool reachability (comm range)
    priority: np.ndarray,             # (N, N) float, phase-selected
    bandwidth_budget: np.ndarray,     # (N,) in units of b
    max_neighbors: Optional[int] = None,
) -> PTCAResult:
    n = len(active)
    links = np.zeros((n, n), bool)
    used = np.zeros(n, np.float64)
    # per-active-worker candidate arrays, descending priority (Alg. 3 lines
    # 2-5); one stable numpy argsort per row instead of a Python key-lambda
    # sort — this is a per-round hot path at burst activations
    act = np.flatnonzero(active)
    candidates: Dict[int, np.ndarray] = {}
    for i in act:
        reach = in_range[i].copy()
        reach[i] = False
        cand = np.flatnonzero(reach)
        if len(cand):
            cand = cand[np.argsort(-priority[i, cand], kind="stable")]
        candidates[int(i)] = cand

    ptr = {i: 0 for i in candidates}           # consumed-prefix pointer
    n_selected = {i: 0 for i in candidates}
    prev_total = -1.0
    while True:
        for i, cand in candidates.items():
            if used[i] + 1 > bandwidth_budget[i]:        # puller budget (line 8)
                continue
            if max_neighbors is not None and n_selected[i] >= max_neighbors:
                continue
            p = ptr[i]
            while p < len(cand):
                j = cand[p]
                p += 1
                if used[j] + 1 > bandwidth_budget[j]:    # pushee budget (line 11)
                    continue                             # consumed: skip forever
                links[i, j] = True                       # line 14
                used[i] += 1.0
                used[j] += 1.0
                n_selected[i] += 1
                break
            ptr[i] = p
        total = used.sum()
        if total == prev_total:                          # lines 18-21
            break
        prev_total = total
    return PTCAResult(links=links, bandwidth_used=used)


def ptca(t: int, t_thre: int, active: np.ndarray, in_range: np.ndarray,
         class_counts: np.ndarray, phys_dist: np.ndarray,
         pull_counts: np.ndarray, tau: np.ndarray,
         bandwidth_budget: np.ndarray,
         max_neighbors: Optional[int] = None,
         phase1_priority: Optional[np.ndarray] = None) -> PTCAResult:
    """Full Alg. 3: choose the phase priority, then greedy construction.

    ``phase1_priority`` optionally short-circuits Eq. 45/46: both depend only
    on static quantities (label histograms, physical positions), so callers
    that run every round precompute it once instead of re-deriving the
    O(N^2 C) EMD matrix per phase-1 round.
    """
    if t <= t_thre:
        prio = (phase1_priority if phase1_priority is not None
                else priority_phase1(emd_matrix(class_counts), phys_dist))
    else:
        prio = priority_phase2(pull_counts, tau, t,
                               rows=np.flatnonzero(active))
    return construct_topology(active, in_range, prio, bandwidth_budget,
                              max_neighbors)

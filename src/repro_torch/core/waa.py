"""Worker Activation Algorithm (paper Alg. 2).

Sort workers by their estimated round cost H_t^i (local-training remainder +
slowest in-link transfer, Eqs. 7-8), then scan prefixes of the sorted order;
for each prefix pre-update staleness and evaluate the drift-plus-penalty
function (Eq. 34); return the prefix minimizing it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.staleness import StalenessState


def worker_activation(state: StalenessState, round_cost: np.ndarray, V: float,
                      max_workers: int | None = None) -> Tuple[np.ndarray, float]:
    """Returns (active_mask (N,) bool, best drift-plus-penalty score).

    round_cost: H_t^i estimate per worker (Eq. 8).
    max_workers: optional cap on |A_t| (defaults to N).

    Vectorized prefix scan: activating the k cheapest workers zeroes their
    previewed staleness, so Eq. 34 for prefix k decomposes into
    ``sum_{i not in prefix} q_i (tau_i + 1) - tau_bound * sum_i q_i
    + V * cost_(k)`` — a cumulative sum over the sorted order instead of an
    O(N) re-evaluation per candidate prefix (O(N log N) total, no Python
    loop; this runs every simulated round).
    """
    n = len(round_cost)
    order = np.argsort(round_cost, kind="stable")
    limit = n if max_workers is None else min(max_workers, n)
    if limit == 0:                     # degenerate cap: activate the cheapest
        active = np.zeros(n, bool)     # worker anyway (pre-vectorization
        active[order[:1]] = True       # behavior), score undefined
        return active, float("inf")

    sorted_cost = np.asarray(round_cost, np.float64)[order[:limit]]
    # per-worker queue cost if it stays inactive: q_i * (tau_i + 1)
    stale_cost = (state.queue * (state.tau + 1.0))[order]
    inactive_sum = stale_cost.sum() - np.cumsum(stale_cost[:limit])
    # Eq. 34 per prefix; H_t for the prefix is its largest (= k-th smallest)
    # cost (Eq. 9) thanks to the sorted order
    scores = (inactive_sum - state.tau_bound * state.queue.sum()
              + V * sorted_cost)
    best_k = int(np.argmin(scores)) + 1    # first minimum, as in Alg. 2
    active = np.zeros(n, bool)
    active[order[:best_k]] = True
    return active, float(scores[best_k - 1])

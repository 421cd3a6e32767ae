"""Dirichlet non-IID partitioner (paper section VI-A2).

The paper controls statistical heterogeneity with a Dirichlet concentration
parameter φ: each class's sample mass is split across the N workers by a
draw from Dirichlet(φ, ..., φ), so smaller φ concentrates a class on fewer
workers (harder non-IID) and — per the paper's convention — **φ >= 1.0 is
treated as exactly IID** (every worker gets a uniform 1/N share of every
class), not as a Dirichlet draw.  φ is the x-axis of the non-IID sweeps and
the cell axis of ``benchmarks/arena.py`` (``phi1`` = IID, ``phi0.4`` = the
paper's non-IID comparison setting).

The resulting ``class_counts`` matrix is ALSO control-plane input: PTCA's
phase-1 priority (Eq. 45/46) ranks neighbors by the EMD between class
histograms, so the partitioner is where data heterogeneity enters topology
construction.  ``dirichlet_partition`` is rng-isolated (its own
``default_rng(seed)``) — it never touches the planner's shared round stream.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.data.synthetic import ClassificationData


def dirichlet_partition(data: ClassificationData, n_workers: int, phi: float,
                        seed: int = 0, min_per_worker: int = 8
                        ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Split ``data`` across ``n_workers`` with Dirichlet(φ) class skew.

    Args:
      data: the full training set (``data.y`` holds integer class labels).
      n_workers: fleet size N.
      phi: Dirichlet concentration; ``phi >= 1.0`` means IID (uniform
        mixture), smaller values skew per-worker class mixtures harder.
      seed: partition rng seed — independent of the simulation's round
        stream, so the same (data, N, φ, seed) always yields the same
        partition on every engine path.
      min_per_worker: starved workers are topped up to this many samples
        (uniformly, with replacement across classes) so every local dataset
        stays trainable; the top-up counts land in ``class_counts`` too.

    Returns:
      ``(assignments, class_counts)``: per-worker sample index arrays
      (int64, into ``data``), and the (N, C) per-worker class histogram in
      SAMPLES — the input to PTCA's EMD matrix and the ``data_sizes``
      weighting of the Eq. 4 mixing matrix.
    """
    rng = np.random.default_rng(seed)
    n_classes = data.n_classes
    idx_by_class = [np.flatnonzero(data.y == c) for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)

    if phi >= 1.0:  # IID: uniform class mixture on every worker
        props = np.full((n_classes, n_workers), 1.0 / n_workers)
    else:
        props = rng.dirichlet([phi] * n_workers, size=n_classes)  # (C, N)

    assignments: List[List[int]] = [[] for _ in range(n_workers)]
    class_counts = np.zeros((n_workers, n_classes), np.int64)
    for c in range(n_classes):
        idx = idx_by_class[c]
        splits = (np.cumsum(props[c]) * len(idx)).astype(int)[:-1]
        for w, part in enumerate(np.split(idx, splits)):
            assignments[w].extend(part.tolist())
            class_counts[w, c] = len(part)

    # top-up starved workers so every local dataset is trainable
    all_idx = np.arange(len(data.y))
    for w in range(n_workers):
        if len(assignments[w]) < min_per_worker:
            extra = rng.choice(all_idx, size=min_per_worker - len(assignments[w]),
                               replace=False)
            assignments[w].extend(extra.tolist())
            for e in extra:
                class_counts[w, data.y[e]] += 1
    return [np.array(a, np.int64) for a in assignments], class_counts

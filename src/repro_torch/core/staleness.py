"""Staleness bookkeeping + Lyapunov machinery (paper Eqs. 6, 33, 34).

All control-plane state is small (O(N) vectors) and lives on host in numpy —
exactly like the paper's coordinator, which only ever sees scalars per worker.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StalenessState:
    """Per-worker staleness tau_t^i and virtual queue q_t^i."""
    tau: np.ndarray          # (N,) int
    queue: np.ndarray        # (N,) float
    tau_bound: int

    @classmethod
    def create(cls, n_workers: int, tau_bound: int) -> "StalenessState":
        return cls(tau=np.zeros(n_workers, np.int64),
                   queue=np.zeros(n_workers, np.float64),
                   tau_bound=int(tau_bound))

    def advance(self, active_mask: np.ndarray) -> None:
        """Eq. (6): tau_{t+1} = (tau_t + 1) * (1 - a_t); Eq. (33) queue update."""
        active_mask = np.asarray(active_mask, bool)
        # queue uses the *current* round staleness before reset
        self.queue = np.maximum(self.queue + self.tau - self.tau_bound, 0.0)
        self.tau = (self.tau + 1) * (~active_mask)

    def reset(self, mask: np.ndarray) -> None:
        """Zero the staleness clock and virtual queue of the masked workers.

        Scenario-plane rejoin semantics (``core.scenarios``): a worker that
        churns back in re-syncs before participating, so its rounds-since-
        activation clock and Eq. 33 queue restart — otherwise the queue
        integrates the whole absence and WAA over-prioritizes the rejoiner
        for many rounds after it returns.
        """
        mask = np.asarray(mask, bool)
        self.tau[mask] = 0
        self.queue[mask] = 0.0

    def previewed_tau(self, active_mask: np.ndarray) -> np.ndarray:
        """tau after a hypothetical activation (used by WAA's pre-update)."""
        return (self.tau + 1) * (~np.asarray(active_mask, bool))


def drift_plus_penalty(queue: np.ndarray, tau_next: np.ndarray, tau_bound: int,
                       round_duration: float, V: float) -> float:
    """Eq. (34): sum_i q_t^i (tau_t^i - tau_bound) + V * H_t.

    `tau_next` is the previewed staleness under the candidate active set (the
    WAA pre-update, Alg. 2 line 5)."""
    return float(np.sum(queue * (tau_next - tau_bound)) + V * round_duration)


def max_staleness(tau: np.ndarray) -> int:
    """Fleet-wide max tau (ROUNDS since last activation; Eq. 12c's tau_max
    constraint is on this quantity)."""
    return int(np.max(tau)) if len(tau) else 0

"""Theorem 1 convergence-bound evaluator (the port of
``repro.core.convergence``; numpy only, so its bound over a ``bound_log`` is
the JAX package's to the last bit).

Bound_T = sum_i alpha_i * rho^{psi_i T / (1 + tau_max)} * (F(w_0) - F*)
          + A . sum_t Delta_t,
Delta_t = W_t sum_{r<t} Delta_r + Z_t   (Eq. 27), with
  W_t = diag(rho if i activated else 1),
  Z_t^i = sum_j sigma_t^{i,j} delta_j for activated i (else 0),
  rho = 1 - mu*eta,  delta_i = eta/2 * xi_i^2 + L * eta^2 * g_i*  (Lemma 1).

Used by tests (Corollaries 1-3 monotonicity) and the staleness benchmark to
connect measured activation histories to the theory.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def lemma1_delta(eta: float, L: float, xi: np.ndarray, g_star: np.ndarray
                 ) -> np.ndarray:
    """delta_i = eta/2 * xi_i^2 + L * eta^2 * g_i*."""
    return eta / 2.0 * np.square(xi) + L * eta ** 2 * np.asarray(g_star)


def convergence_bound(
    active_hist: Sequence[np.ndarray],      # T x (N,) bool
    mix_hist: Sequence[np.ndarray],         # T x (N, N) row-stochastic W_t
    alpha: np.ndarray,                      # (N,) data weights
    f0_gap: float,                          # F(w_0) - F*
    eta: float, mu: float, L: float,
    xi: np.ndarray, g_star: np.ndarray,
) -> float:
    """Evaluate Bound_T for a recorded activation/topology history."""
    assert eta < mu / (2 * L ** 2) + 1e-12, "Lemma 1 requires eta < mu/(2L^2)"
    T = len(active_hist)
    n = len(alpha)
    rho = 1.0 - mu * eta
    delta = lemma1_delta(eta, L, xi, g_star)

    # activation frequencies psi_i and max staleness from the history
    act = np.stack(active_hist)                      # (T, N)
    psi = act.mean(axis=0)
    tau = np.zeros(n)
    tau_max = 0.0
    for t in range(T):
        tau = (tau + 1) * (~act[t])
        tau_max = max(tau_max, tau.max())

    decay = np.sum(alpha * rho ** (psi * T / (1.0 + tau_max))) * f0_gap

    # Delta recursion (Eq. 27).  NOTE: Theorem 1 states W_t = diag(rho | 1),
    # but substituting back into Lemma 2 the factor is (X_t + sum Y_t - E),
    # i.e. (rho - 1) for activated workers and 0 otherwise — the theorem's
    # statement drops the "-E" (with it the series is contractive; as printed
    # it diverges ~2^T).  We implement the Lemma-2-consistent form.
    delta_sum = np.zeros(n)
    noise = np.zeros(n)
    for t in range(T):
        w_diag = np.where(act[t], rho - 1.0, 0.0)
        z = np.where(act[t], mix_hist[t] @ delta, 0.0)
        d_t = w_diag * delta_sum + z
        delta_sum = delta_sum + d_t
        noise += d_t
    return float(decay + alpha @ noise)


def bound_vs_tau_max(tau_max_values: Sequence[int], psi: float, T: int,
                     rho: float, f0_gap: float) -> List[float]:
    """Corollary 1: the decay term as a function of tau_max (all else fixed)."""
    return [float(rho ** (psi * T / (1.0 + tm)) * f0_gap) for tm in tau_max_values]


def bound_vs_psi(psi_values: Sequence[float], tau_max: int, T: int,
                 rho: float, f0_gap: float) -> List[float]:
    """Corollary 2: the decay term as a function of activation frequency."""
    return [float(rho ** (p * T / (1.0 + tau_max)) * f0_gap) for p in psi_values]

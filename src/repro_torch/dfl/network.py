"""Edge-network model: geometric placement, Shannon-rate wireless links,
time-varying channel gains, comm ranges (paper section VI-A1).

Defaults follow the paper's simulation setup: 100m x 100m region, path-loss
constant G0 = -43 dB at 1 m with d^-4 decay, transmit power 10-20 dBm with
per-worker fluctuation, noise power 1e-13 W, link bandwidth b = 1 MHz.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class NetworkConfig:
    n_workers: int = 100
    region_m: float = 100.0
    comm_range_m: float = 40.0
    g0_db: float = -43.0
    tx_power_dbm_lo: float = 10.0
    tx_power_dbm_hi: float = 20.0
    noise_w: float = 1e-13
    bandwidth_hz: float = 1e6
    gain_fluctuation: float = 0.2     # lognormal sigma on per-round channel
    dynamics_drop_prob: float = 0.02  # per-round chance a link blinks out

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"NetworkConfig.n_workers must be >= 1, got "
                             f"{self.n_workers}")
        if not (0.0 <= self.dynamics_drop_prob <= 1.0):
            raise ValueError(
                f"NetworkConfig.dynamics_drop_prob must be in [0, 1] (a "
                f"per-round per-link blink-out probability), got "
                f"{self.dynamics_drop_prob} — values outside the unit "
                f"interval silently degenerate to 'never' or 'always'")
        if self.gain_fluctuation < 0.0:
            raise ValueError(
                f"NetworkConfig.gain_fluctuation must be >= 0 (a lognormal "
                f"sigma), got {self.gain_fluctuation}")
        for f in ("region_m", "comm_range_m", "noise_w", "bandwidth_hz"):
            v = getattr(self, f)
            if v <= 0:
                raise ValueError(f"NetworkConfig.{f} must be > 0, got {v}")


class EdgeNetwork:
    """Positions, distances, per-round link rates (bytes/s)."""

    def __init__(self, cfg: NetworkConfig, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng
        n = cfg.n_workers
        self.pos = rng.uniform(0, cfg.region_m, size=(n, 2))
        diff = self.pos[:, None, :] - self.pos[None, :, :]
        self.dist = np.sqrt((diff ** 2).sum(-1)) + 1e-9
        np.fill_diagonal(self.dist, 0.0)
        p_dbm = rng.uniform(cfg.tx_power_dbm_lo, cfg.tx_power_dbm_hi, size=n)
        self.tx_power_w = 10 ** ((p_dbm - 30) / 10)
        # mean channel gains are static (positions don't move): precompute the
        # path-loss power once — link_rates() is a per-round hot path and the
        # O(N^2) d^-4 power was ~25% of its cost
        g0 = 10 ** (cfg.g0_db / 10)
        with np.errstate(divide="ignore"):
            self._mean_gain = g0 * np.where(self.dist > 0, self.dist,
                                            np.inf) ** -4
        self._mean_gain_floor = np.maximum(self._mean_gain, 1e-30)

    def in_range(self) -> np.ndarray:
        r = (self.dist <= self.cfg.comm_range_m)
        np.fill_diagonal(r, False)
        return r

    def _sample_round_channels(self, dynamic: bool):
        """Draw one round's channel randomness (the FULL (N, N) arrays).

        The rng stream is the trajectory: every consumer — dense
        ``link_rates`` and the sparse ``sample_link_row_max`` hot path —
        must consume the exact same draws in the exact same order, so the
        sampling is factored here and only the (deterministic) Shannon
        transform differs between them.
        """
        cfg = self.cfg
        gain = self.rng.exponential(self._mean_gain_floor)
        if dynamic:
            gain = gain * self.rng.lognormal(0.0, cfg.gain_fluctuation,
                                             gain.shape)
        drop = None
        if dynamic and cfg.dynamics_drop_prob > 0:
            drop = self.rng.random(gain.shape) < cfg.dynamics_drop_prob
        return gain, drop

    def _shannon_rate(self, gain, tx_power_w):
        """bytes/s for the given gains (elementwise; any shape)."""
        cfg = self.cfg
        snr = tx_power_w * gain / cfg.noise_w
        return cfg.bandwidth_hz * np.log2(1.0 + snr) / 8.0

    def link_rates(self, dynamic: bool = True,
                   rate_scale: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-round Shannon rates (N, N) in bytes/s for j -> i transfers.

        ``rate_scale`` (scenario plane, ``core.scenarios.RoundOverlay``): a
        deterministic (N, N) multiplier applied AFTER sampling — the rng
        draws are identical with and without it, so fault windows never
        perturb the trajectory of the rounds around them.
        """
        gain, drop = self._sample_round_channels(dynamic)
        rate = self._shannon_rate(gain, self.tx_power_w[None, :])
        if drop is not None:
            # edge dynamics: a blinked-out link degrades to a deep fade (the
            # transfer stalls and is re-established, ~50x slower effective rate)
            rate = np.where(drop, rate * 0.02, rate)
        if rate_scale is not None:
            rate = rate * rate_scale
        np.fill_diagonal(rate, np.inf)
        return rate

    def sample_link_row_max(self, model_bytes: float, needed: np.ndarray,
                            dynamic: bool = True,
                            rate_scale: Optional[np.ndarray] = None
                            ) -> np.ndarray:
        """Per-row max transfer TIME (seconds) over the ``needed`` links.

        The per-round control plane only ever reads the sampled channels at
        the round's link entries (``np.where(links, t, 0).max(axis=1)``), so
        this consumes the identical rng draws as ``link_rates`` but applies
        the Shannon transform to the ~k·max_neighbors needed entries instead
        of all N² — the planner hot path.  Bitwise-equal to the dense route
        on the needed entries; rows with no needed link return 0.0.  Apply
        timeout ceilings AFTER the row max: ``max_j min(t_j, c) ==
        min(max_j t_j, c)`` since clamping is monotone.

        ``rate_scale`` mirrors ``link_rates``: a deterministic (N, N)
        multiplier on the sampled rates (scenario degradation windows),
        applied to the needed entries only — same draws either way.
        """
        gain, drop = self._sample_round_channels(dynamic)
        out = np.zeros(needed.shape[0], np.float64)
        rows, cols = np.nonzero(needed)
        if len(rows) == 0:
            return out
        rate = self._shannon_rate(gain[rows, cols], self.tx_power_w[cols])
        if drop is not None:
            rate = np.where(drop[rows, cols], rate * 0.02, rate)
        if rate_scale is not None:
            rate = rate * rate_scale[rows, cols]
        np.maximum.at(out, rows, model_bytes / rate)
        return out

    def expected_link_time(self, model_bytes: float) -> np.ndarray:
        """Deterministic (mean-gain) transfer-time estimate used by WAA."""
        cfg = self.cfg
        snr = self.tx_power_w[None, :] * self._mean_gain / cfg.noise_w
        rate = cfg.bandwidth_hz * np.log2(1.0 + snr) / 8.0
        with np.errstate(divide="ignore"):
            t = model_bytes / rate
        np.fill_diagonal(t, 0.0)
        return t


def heterogeneous_compute_times(n: int, base_s: float, rng: np.random.Generator,
                                sigma: float = 0.35) -> np.ndarray:
    """Per-worker local-training time h_i in simulated SECONDS (paper Eq. 7's
    per-round compute term): base batch time x lognormal speed factor
    (paper: measured batch time x normal coefficient; the testbed spans
    Jetson Nano -> Orin, ~10x)."""
    return base_s * rng.lognormal(0.0, sigma, size=n)

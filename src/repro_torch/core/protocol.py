"""DySTop round engine (paper Alg. 1): the coordinator's decisions.

A ``Mechanism`` makes per-round control-plane decisions: which workers to
activate (EXECUTE) and which links to build (the neighbors each activated
worker PULLs from).  ``DySTop`` = WAA (Alg. 2) + PTCA (Alg. 3).

Contract: ``Mechanism.round`` sees ONLY the ``RoundContext`` scalars — never
model values (exactly the paper's coordinator, which exchanges bookkeeping
messages, not weights).  ``core.planner.HorizonPlanner`` relies on this to
replay H rounds of decisions ahead of the device so the engine can execute
them as one mega-round; any rng a mechanism needs must come from ``ctx.rng``
(the planner threads the shared host generator through in round order,
keeping trajectories bit-for-bit reproducible).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import ptca as PT
from repro_torch.core import waa as WA
from repro_torch.core.staleness import StalenessState


@dataclasses.dataclass
class RoundContext:
    """Everything the coordinator can see at the start of round t (scalars per
    worker — it never touches model weights).

    ``in_range`` is the INSTANTANEOUS link availability: the static geometry
    masked by this round's down workers and scenario blackout/mobility
    overlays.  ``base_in_range`` (when the caller provides it) is the static
    base graph — what mechanisms with one-time structural preprocessing
    (MATCHA's matching decomposition) must key on, since the masked view
    varies round to round and run to run.  Decisions are still masked against
    the instantaneous state by the planner after ``Mechanism.round`` returns.
    """
    t: int
    round_cost: np.ndarray        # (N,) H_t^i estimate (Eq. 8)
    readiness: np.ndarray         # (N,) h_i - time-since-activation (FIFO order:
                                  #   most negative = finished longest ago)
    in_range: np.ndarray          # (N, N) bool (this round, failure-masked)
    class_counts: np.ndarray      # (N, C)
    phys_dist: np.ndarray         # (N, N)
    pull_counts: np.ndarray       # (N, N)
    staleness: StalenessState
    bandwidth_budget: np.ndarray  # (N,) transfers of size b per round
    data_sizes: np.ndarray        # (N,)
    rng: np.random.Generator
    base_in_range: Optional[np.ndarray] = None  # (N, N) bool static geometry


@dataclasses.dataclass
class RoundDecision:
    active: np.ndarray            # (N,) bool
    links: np.ndarray             # (N, N) bool: i pulls from j
    synchronous: bool = False     # sync mechanisms pay full h_i each round


class Mechanism:
    name = "base"

    def round(self, ctx: RoundContext) -> RoundDecision:  # pragma: no cover
        raise NotImplementedError


class DySTop(Mechanism):
    """The paper's mechanism: Lyapunov worker activation + phase-aware topology."""
    name = "dystop"

    def __init__(self, V: float = 10.0, t_thre: int = 50,
                 max_neighbors: Optional[int] = 7,
                 max_workers: Optional[int] = None):
        self.V = V
        self.t_thre = t_thre
        self.max_neighbors = max_neighbors
        self.max_workers = max_workers
        self._prio1_key = None          # phase-1 priority cache (static inputs)
        self._prio1 = None

    def _phase1_priority(self, ctx: RoundContext) -> np.ndarray:
        """Eq. 45/46 depend only on static per-simulation state — cache it.

        The key holds strong references and compares with ``is`` so a
        recycled object address from a different simulation can never serve
        stale priorities.
        """
        key = (ctx.class_counts, ctx.phys_dist)
        if (self._prio1_key is None
                or self._prio1_key[0] is not key[0]
                or self._prio1_key[1] is not key[1]):
            self._prio1 = PT.priority_phase1(PT.emd_matrix(ctx.class_counts),
                                             ctx.phys_dist)
            self._prio1_key = key
        return self._prio1

    def round(self, ctx: RoundContext) -> RoundDecision:
        active, _ = WA.worker_activation(ctx.staleness, ctx.round_cost, self.V,
                                         self.max_workers)
        top = PT.ptca(ctx.t, self.t_thre, active, ctx.in_range, ctx.class_counts,
                      ctx.phys_dist, ctx.pull_counts, ctx.staleness.tau,
                      ctx.bandwidth_budget, self.max_neighbors,
                      phase1_priority=(self._phase1_priority(ctx)
                                       if ctx.t <= self.t_thre else None))
        return RoundDecision(active=active, links=top.links)

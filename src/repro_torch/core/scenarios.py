"""Deterministic scenario/fault-injection plane.

DySTop's headline claim is efficiency under *heterogeneous and dynamic edge
environments* — churn, fading channels, stragglers (paper section VI; the
DFL deployment-performance study in PAPERS.md shows deployment dynamics
dominate real DFL behavior).  This module turns those dynamics into a
declarative, replayable ``ScenarioSchedule``: a list of timed events compiled
into per-round ``RoundOverlay``s that ``core.planner.HorizonPlanner``
consumes ahead of the device.

The cardinal invariant: **overlays never touch the rng stream**.  Every event
is a deterministic function of the round index (and static network geometry),
applied as a mask/scale on top of the stochastic draws the planner already
makes — so a scenario replays bit-identically on the fused, legacy, and
mesh-sharded engines at any ``scan_horizon`` (the rng stream IS the
trajectory, and the stream never moves).

Graceful-degradation semantics ride through the existing machinery:

* churned-out workers are masked out of activation and links, so their
  resident buffer rows simply stay idle (the bucket padding scheme already
  guarantees idle rows are never gathered, mixed, or evaluated);
* a rejoiner gets a staleness reset (``StalenessState.reset``): its
  ``tau``/virtual-queue clocks restart at zero, modeling the standard DFL
  join protocol where a returning worker re-syncs before participating —
  without the reset the Eq. 33 queue integrates the whole absence and WAA
  over-prioritizes the rejoiner for many rounds;
* an activated worker whose selected neighbors are ALL down degrades to
  self-weight: Eq. 4's in-neighbor set is ``{pulled} ∪ {self}``, so with
  every pull masked the mixing row collapses to ``e_i`` and the worker
  trains solo instead of stalling the round.

Units: event times are ROUND indices (1-based, matching ``PlannedRound.t``);
windows are half-open ``[t_start, t_end)``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


def _check_window(name: str, t_start: int, t_end: int) -> None:
    if t_start < 1:
        raise ValueError(
            f"{name}.t_start must be >= 1 (round indices are 1-based, "
            f"matching PlannedRound.t), got {t_start}")
    if t_end <= t_start:
        raise ValueError(
            f"{name} window is empty: t_end ({t_end}) must be > t_start "
            f"({t_start}) — windows are half-open [t_start, t_end)")


def _check_workers(name: str, workers: Optional[Sequence[int]]) -> None:
    if workers is not None and len(workers) == 0:
        raise ValueError(f"{name}.workers is an empty tuple — pass None for "
                         f"'the whole fleet' or at least one worker id")


@dataclasses.dataclass(frozen=True)
class Churn:
    """Worker ``worker`` leaves the federation at round ``leave_t`` and
    rejoins at ``rejoin_t`` (``None`` = never).  While out it can neither
    train nor serve pulls — exactly the planner's down-mask semantics — and
    on rejoin its staleness clocks reset (see module docstring)."""
    worker: int
    leave_t: int
    rejoin_t: Optional[int] = None

    def __post_init__(self):
        if self.leave_t < 1:
            raise ValueError(f"Churn.leave_t must be >= 1, got {self.leave_t}")
        if self.rejoin_t is not None and self.rejoin_t <= self.leave_t:
            raise ValueError(
                f"Churn.rejoin_t ({self.rejoin_t}) must be > leave_t "
                f"({self.leave_t}) — the worker must be out for >= 1 round")


@dataclasses.dataclass(frozen=True)
class Blackout:
    """Link blackout: every link touching ``workers`` (``None`` = ALL links)
    is unusable during ``[t_start, t_end)``.  Workers stay up — they can
    still activate and train on their own data (self-weight fallback)."""
    t_start: int
    t_end: int
    workers: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        _check_window("Blackout", self.t_start, self.t_end)
        _check_workers("Blackout", self.workers)


@dataclasses.dataclass(frozen=True)
class Degrade:
    """Channel-degradation window: link rates touching ``workers`` (``None``
    = the whole fleet) are multiplied by ``factor`` during the window —
    transfer times stretch by 1/factor, bounded by the planner's
    abort/retry timeout ceilings."""
    t_start: int
    t_end: int
    factor: float
    workers: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        _check_window("Degrade", self.t_start, self.t_end)
        _check_workers("Degrade", self.workers)
        if not (0.0 < self.factor <= 1.0):
            raise ValueError(
                f"Degrade.factor must be in (0, 1] (a rate multiplier; 1 = "
                f"no degradation), got {self.factor}")


@dataclasses.dataclass(frozen=True)
class Straggle:
    """Compute slowdown: ``workers``' local-training time h_i is multiplied
    by ``factor`` (> 1) during the window — the slow-worker tail where
    staleness control should shine."""
    t_start: int
    t_end: int
    workers: Tuple[int, ...]
    factor: float = 4.0

    def __post_init__(self):
        _check_window("Straggle", self.t_start, self.t_end)
        if not self.workers:
            raise ValueError("Straggle.workers must name at least one worker")
        if self.factor <= 1.0:
            raise ValueError(
                f"Straggle.factor must be > 1 (an h_i multiplier), got "
                f"{self.factor}")


@dataclasses.dataclass(frozen=True)
class Mobility:
    """Mobility window: ``workers`` move toward the edge of coverage — links
    beyond ``range_scale`` x the nominal comm range drop entirely, and the
    surviving links degrade to ``rate_factor`` x their sampled rate.
    Compiling a schedule with Mobility events requires the network's static
    distance matrix (``ScenarioSchedule.compile(dist=, comm_range_m=)``)."""
    t_start: int
    t_end: int
    workers: Tuple[int, ...]
    range_scale: float = 0.5
    rate_factor: float = 0.5

    def __post_init__(self):
        _check_window("Mobility", self.t_start, self.t_end)
        if not self.workers:
            raise ValueError("Mobility.workers must name at least one worker")
        if not (0.0 < self.range_scale <= 1.0):
            raise ValueError(f"Mobility.range_scale must be in (0, 1], got "
                             f"{self.range_scale}")
        if not (0.0 < self.rate_factor <= 1.0):
            raise ValueError(f"Mobility.rate_factor must be in (0, 1], got "
                             f"{self.rate_factor}")


Event = Union[Churn, Blackout, Degrade, Straggle, Mobility]


@dataclasses.dataclass(frozen=True)
class RoundOverlay:
    """One round's compiled fault state, consumed by ``plan_round``.

    ``None`` fields mean "no constraint this round" so the planner's
    no-scenario fast path stays untouched.  ``rate_scale`` multiplies the
    SAMPLED link rates (a deterministic post-transform — the channel rng
    draws are identical with and without it); ``compute_scale`` multiplies
    h_i; ``link_ok`` masks ``in_range``; ``forced_down`` ORs into the
    stochastic failure mask; ``rejoined`` names the workers whose staleness
    clocks reset at the START of this round.
    """
    forced_down: Optional[np.ndarray] = None    # (N,) bool
    rejoined: Optional[np.ndarray] = None       # (N,) bool
    link_ok: Optional[np.ndarray] = None        # (N, N) bool
    rate_scale: Optional[np.ndarray] = None     # (N, N) f64 multiplier
    compute_scale: Optional[np.ndarray] = None  # (N,) f64 multiplier


_EMPTY = RoundOverlay()


@dataclasses.dataclass(frozen=True)
class ScenarioSchedule:
    """A declarative, deterministic fault schedule: a tuple of timed events.

    ``compile`` resolves it against a fleet size (and, for Mobility, the
    static network geometry) into a ``CompiledScenario`` whose per-round
    overlays the planner consumes.  Schedules are pure data — hashable,
    picklable, and independent of any rng — so the same schedule replays
    identically on every engine path and across checkpoint/resume.
    """
    events: Tuple[Event, ...]
    name: str = "custom"

    def __post_init__(self):
        # tolerate lists at construction; store a tuple (frozen dataclass)
        if not isinstance(self.events, tuple):
            object.__setattr__(self, "events", tuple(self.events))

    def compile(self, n_workers: int, dist: Optional[np.ndarray] = None,
                comm_range_m: Optional[float] = None) -> "CompiledScenario":
        for ev in self.events:
            w = getattr(ev, "workers", None)
            ids = [ev.worker] if isinstance(ev, Churn) else (w or [])
            for i in ids:
                if not (0 <= i < n_workers):
                    raise ValueError(
                        f"{type(ev).__name__} names worker {i} but the fleet "
                        f"has n_workers={n_workers} (ids are 0-based)")
            if isinstance(ev, Mobility) and (dist is None
                                             or comm_range_m is None):
                raise ValueError(
                    "compiling a Mobility event needs the static network "
                    "geometry: pass dist= (the (N, N) distance matrix) and "
                    "comm_range_m= to ScenarioSchedule.compile")
        return CompiledScenario(self, n_workers, dist, comm_range_m)


class CompiledScenario:
    """Schedule resolved against one fleet: ``overlay(t)`` per round.

    Overlays are cached per round index (the planner and any replaying
    oracle ask for the same t repeatedly) and composed from the events
    active at t; rounds with no active event return a shared empty overlay,
    so the no-fault regions of a scenario run pay nothing.
    """

    def __init__(self, schedule: ScenarioSchedule, n_workers: int,
                 dist: Optional[np.ndarray], comm_range_m: Optional[float]):
        self.schedule = schedule
        self.n_workers = n_workers
        self._dist = dist
        self._comm_range_m = comm_range_m
        self._cache: dict = {}
        bounds = set()
        for ev in schedule.events:
            if isinstance(ev, Churn):
                bounds.add(ev.leave_t)
                if ev.rejoin_t is not None:
                    bounds.add(ev.rejoin_t)
            else:
                bounds.add(ev.t_start)
                bounds.add(ev.t_end)
        #: rounds where some event switches on or off.  Drive loops flush their
        #: pending plan chunk when crossing one, so a mega-round
        #: never straddles an event boundary — not needed for correctness
        #: (overlays are per-round) but it keeps dispatch chunks aligned with
        #: the scenario's phases for benchmarking and checkpoint placement.
        self.boundaries = frozenset(bounds)

    def _forced_down(self, t: int) -> np.ndarray:
        down = np.zeros(self.n_workers, bool)
        for ev in self.schedule.events:
            if isinstance(ev, Churn) and ev.leave_t <= t and (
                    ev.rejoin_t is None or t < ev.rejoin_t):
                down[ev.worker] = True
        return down

    def overlay(self, t: int) -> RoundOverlay:
        if t in self._cache:
            return self._cache[t]
        n = self.n_workers
        forced_down = self._forced_down(t)
        rejoined = self._forced_down(t - 1) & ~forced_down if t > 1 else None
        if rejoined is not None and not rejoined.any():
            rejoined = None
        link_ok: Optional[np.ndarray] = None
        rate_scale: Optional[np.ndarray] = None
        compute_scale: Optional[np.ndarray] = None

        def _link_ok():
            nonlocal link_ok
            if link_ok is None:
                link_ok = np.ones((n, n), bool)
            return link_ok

        def _rate_scale():
            nonlocal rate_scale
            if rate_scale is None:
                rate_scale = np.ones((n, n), np.float64)
            return rate_scale

        def _touching(workers) -> np.ndarray:
            """(N, N) bool: links with either endpoint in ``workers``."""
            m = np.zeros(n, bool)
            m[list(workers)] = True
            return m[:, None] | m[None, :]

        for ev in self.schedule.events:
            if isinstance(ev, Churn) or not (ev.t_start <= t < ev.t_end):
                continue
            if isinstance(ev, Blackout):
                if ev.workers is None:
                    _link_ok()[:] = False
                else:
                    _link_ok()[_touching(ev.workers)] = False
            elif isinstance(ev, Degrade):
                sel = (slice(None) if ev.workers is None
                       else _touching(ev.workers))
                rs = _rate_scale()
                rs[sel] = rs[sel] * ev.factor
            elif isinstance(ev, Straggle):
                if compute_scale is None:
                    compute_scale = np.ones(n, np.float64)
                compute_scale[list(ev.workers)] *= ev.factor
            elif isinstance(ev, Mobility):
                lost = (_touching(ev.workers)
                        & (self._dist > ev.range_scale * self._comm_range_m))
                _link_ok()[lost] = False
                rs = _rate_scale()
                kept = _touching(ev.workers) & ~lost
                rs[kept] = rs[kept] * ev.rate_factor
        ov = (_EMPTY if (not forced_down.any() and rejoined is None
                         and link_ok is None and rate_scale is None
                         and compute_scale is None)
              else RoundOverlay(
                  forced_down=forced_down if forced_down.any() else None,
                  rejoined=rejoined, link_ok=link_ok, rate_scale=rate_scale,
                  compute_scale=compute_scale))
        self._cache[t] = ov
        return ov


# --------------------------------------------------------------------------- #
# presets: the SimConfig/LMRunConfig scenario vocabulary
# --------------------------------------------------------------------------- #


SCENARIO_PRESETS = ("churn20", "blackout", "straggler_tail", "mobile")


def get_scenario(name: str, n_workers: int, n_rounds: int) -> ScenarioSchedule:
    """Deterministic preset schedules, scaled to the run's (N, T) geometry.

    * ``churn20``   — 20% of the fleet churns out in a staggered wave around
                      T/3 and rejoins around 2T/3 (staleness-reset rejoins).
    * ``blackout``  — a full-network link blackout for the middle ~15% of the
                      run: every activated worker trains solo (self-weight
                      fallback), then connectivity returns.
    * ``straggler_tail`` — the last 10% of worker ids slow down 8x for the
                      second half of the run (the heterogeneous-compute tail).
    * ``mobile``    — 30% of the fleet takes staggered mobility excursions:
                      range shrinks to 40%, surviving links degrade to 30%.

    All presets are pure functions of (name, n_workers, n_rounds) — no rng —
    so they replay bit-identically on every engine path.
    """
    if n_workers < 2 or n_rounds < 10:
        raise ValueError(
            f"scenario presets need n_workers >= 2 and n_rounds >= 10 to "
            f"place their windows, got N={n_workers}, T={n_rounds}")
    t3, t23 = max(2, n_rounds // 3), max(3, (2 * n_rounds) // 3)
    events: List[Event] = []
    if name == "churn20":
        k = max(1, n_workers // 5)
        # strided picks spread the churners across the (geometric) fleet;
        # staggered leave/rejoin so the wave is gradual, not a step
        workers = [(i * max(1, n_workers // k)) % n_workers for i in range(k)]
        for j, w in enumerate(sorted(set(workers))[:k]):
            events.append(Churn(worker=w, leave_t=t3 + j % 3,
                                rejoin_t=t23 + j % 3))
    elif name == "blackout":
        width = max(2, (3 * n_rounds) // 20)
        lo = max(1, n_rounds // 2 - width // 2)
        events.append(Blackout(t_start=lo, t_end=lo + width))
    elif name == "straggler_tail":
        k = max(1, n_workers // 10)
        tail = tuple(range(n_workers - k, n_workers))
        events.append(Straggle(t_start=max(1, n_rounds // 2),
                               t_end=n_rounds + 1, workers=tail, factor=8.0))
    elif name == "mobile":
        k = max(1, (3 * n_workers) // 10)
        movers = [(i * max(1, n_workers // k)) % n_workers for i in range(k)]
        width = max(3, n_rounds // 5)
        for j, w in enumerate(sorted(set(movers))[:k]):
            lo = 1 + (j * max(1, n_rounds // (k + 1))) % max(1, n_rounds - width)
            events.append(Mobility(t_start=lo, t_end=lo + width, workers=(w,),
                                   range_scale=0.4, rate_factor=0.3))
    else:
        raise ValueError(f"unknown scenario preset {name!r}; available: "
                         f"{', '.join(SCENARIO_PRESETS)} (or pass a "
                         f"ScenarioSchedule instance)")
    return ScenarioSchedule(events=tuple(events), name=name)


def resolve_scenario(scenario, n_workers: int, n_rounds: int,
                     dist: Optional[np.ndarray] = None,
                     comm_range_m: Optional[float] = None
                     ) -> Optional[CompiledScenario]:
    """One resolver for every drive loop: ``None`` passes through, a preset name
    looks up ``get_scenario``, a ``ScenarioSchedule`` compiles directly."""
    if scenario is None:
        return None
    if isinstance(scenario, str):
        scenario = get_scenario(scenario, n_workers, n_rounds)
    if not isinstance(scenario, ScenarioSchedule):
        raise ValueError(
            f"scenario must be None, a preset name "
            f"({', '.join(SCENARIO_PRESETS)}), or a ScenarioSchedule — got "
            f"{type(scenario).__name__}")
    return scenario.compile(n_workers, dist=dist, comm_range_m=comm_range_m)

"""Horizon scheduler: plan H control-plane rounds ahead of the model plane.

Every ``Mechanism`` decision (WAA activation, PTCA topology, staleness
bookkeeping, channel/failure dynamics) depends only on round/staleness
scalars — never on model values — so the coordinator can replay H rounds of
Alg. 1 on host and hand the fused engine a *batch* of ``PlannedRound``s to
execute as one mega-round (``dfl.worker.mega_round_step``).
The planner IS the simulator's control plane: ``run_simulation`` drives it
one round at a time (so eval points land exactly where the per-round loop
put them) and flushes the pending plan chunk to the device at horizon
boundaries.

State evolution here is byte-identical to the pre-planner per-round loop:
the shared ``numpy`` rng is consumed in the same order (failure draws, then
the mechanism's own draws, then channel sampling), so trajectories are
bit-for-bit reproducible at any horizon.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.aggregation import (bucket_size, col_union_mask,
                                    mixing_matrix_rows, plan_buckets)
from repro_torch.core.protocol import Mechanism, RoundContext
from repro_torch.core.staleness import StalenessState


@dataclasses.dataclass
class PlannedRound:
    """One fully-resolved control-plane round, ready for device dispatch.

    ``active``/``links`` are post-failure-masking (what the model plane must
    execute); ``W`` is the Eq. 4 mixing matrix; ``duration`` the realized
    H_t with sampled channels (Eq. 9, simulated seconds); ``n_transfers``
    the Eq. 10 accounting; ``mix_cols`` the union of nonzero mixing COLUMNS
    (``core.aggregation.col_union_mask``) — the bucket plan the column-sparse
    engine contracts over, resolved here so the dispatcher never re-derives
    sparsity structure from W.
    """
    t: int
    active: np.ndarray            # (N,) bool
    links: np.ndarray             # (N, N) bool
    synchronous: bool
    W: np.ndarray                 # (N, N) f32
    duration: float
    n_transfers: int
    mix_cols: Optional[np.ndarray] = None   # (N,) bool nonzero-column union
                                  # of W (None ⇒ dispatchers re-derive it)
    mix_rows: Optional[np.ndarray] = None   # sorted non-identity row ids of W
                                  # (``aggregation.mixing_matrix_rows``,
                                  # resolved at plan time; None ⇒ packers
                                  # re-derive ``active | links.any(1)``)
    train_rows: Optional[np.ndarray] = None  # sorted activated row ids
                                  # (flatnonzero(active), resolved at plan
                                  # time; None ⇒ packers re-derive)
    mix_pad: Optional[np.ndarray] = None    # first row id OUTSIDE the mix
                                  # set / the activation — the unsharded
    train_pad: Optional[np.ndarray] = None  # bucket-padding candidates
                                  # (``shard_pad_candidates`` with 1 shard),
                                  # (1,) arrays, empty if no row qualifies
    # memos filled by ``bucket_key``/``mix_is_train`` — the drive loops warm
    # the key memo at plan time so the dispatch path only does lookups.
    # Keyed/value caches only — never part of round identity or checkpoints.
    _key_memo: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)
    _mit_memo: Optional[bool] = dataclasses.field(default=None, repr=False,
                                                  compare=False)


def bucket_key(plan: "PlannedRound", n_workers: int,
               col_sparse: bool = False,
               min_bucket: int = 8, mesh_shards: int = 1) -> Tuple[int, ...]:
    """Power-of-two shape buckets of one planned round.

    ``(k_mix, k_train)`` — plus the bucket of the nonzero-column union when
    the consumer contracts column-sparse — is everything a model plane needs
    to know to batch rounds into one mega-round: every round of a
    chunk must share one contraction shape.  Model-value-independent, so it
    lives with the planner and serves BOTH planes (the MLP simulation engine
    and the LM fleet engine) rather than being re-derived per worker module.
    ``mesh_shards`` only feeds the ``col_union_mask`` fallback for plans
    whose union the planner did not resolve (a sharded planner stores the
    shard-aware union in ``mix_cols`` already).

    Memoized per (col_sparse, min_bucket, mesh_shards) on the plan itself:
    ``chunk_spans``, the horizon packer, and the dispatch pipeline all key on
    the same buckets, and with dispatch pipelined the key is consulted once
    per consumer rather than recomputed — the memo fills lazily at first use
    so its cost stays in the dispatch phase, not the (benchmark-excluded)
    planning phase.  Plans are duck-typed throughout the packers, so a plan
    without the memo slot simply recomputes.
    """
    memo = getattr(plan, "_key_memo", None)
    mk = (col_sparse, min_bucket, mesh_shards)
    if memo is not None:
        key = memo.get(mk)
        if key is not None:
            return key
    base = plan_buckets(plan.active, plan.links, min_bucket)
    if col_sparse:
        cols = (getattr(plan, "mix_cols", None))
        if cols is None:
            cols = col_union_mask(plan.active, plan.links, mesh_shards)
        key = base + (bucket_size(int(cols.sum()), n_workers, min_bucket),)
    else:
        key = base
    if memo is not None:
        memo[mk] = key
    return key


def shard_spans(row_ids: np.ndarray, n_workers: int,
                mesh_shards: int) -> List[Tuple[int, int]]:
    """Per-shard ``[lo, hi)`` segments of a home-shard-grouped gathered id
    vector (``aggregation.padded_rows(shards=...)`` layout).

    The sharded buffer partitions its padded row axis into contiguous blocks
    of ``N_pad // mesh_shards`` rows, one per rank, so a sorted id vector is
    grouped by home shard and each shard's gather/scatter touches one
    contiguous segment of the gathered set.  Raises if the ids are not
    grouped by home shard.
    """
    ids = np.asarray(row_ids)
    n_pad = n_workers + (-n_workers) % mesh_shards
    block = n_pad // mesh_shards
    homes = ids // block
    if not (np.diff(homes) >= 0).all():
        raise ValueError(f"shard_spans: row ids {ids.tolist()} are not "
                         f"grouped by home shard (block {block})")
    bounds = np.searchsorted(homes, np.arange(mesh_shards + 1))
    return [(int(bounds[s]), int(bounds[s + 1])) for s in range(mesh_shards)]


def mix_is_train(plan: "PlannedRound") -> bool:
    """True iff the round's mixing rows EQUAL its training rows — i.e. no
    worker pulls without also being activated (every DySTop round: only
    activated workers build links).  Lets a fused model plane feed the Eq. 4
    output straight into Eq. 5 without scattering and re-gathering the same
    rows; push-style baselines (SA-ADFL) set links on passive receivers and
    return False here.  Memoized on the plan (lazily, at first use) — both
    the lockstep and pipelined dispatchers consult it per chunk.
    """
    memo = getattr(plan, "_mit_memo", None)
    if memo is None:
        memo = not (plan.links.any(axis=1) & ~plan.active).any()
        if hasattr(plan, "_mit_memo"):
            plan._mit_memo = memo
    return memo


def chunk_spans(plans: List["PlannedRound"], n_workers: int,
                col_sparse: bool = False, min_bucket: int = 8,
                mesh_shards: int = 1
                ) -> Iterator[Tuple[int, int, Tuple[int, ...]]]:
    """Split a pending plan list into maximal bucket-uniform ``[lo, hi)``
    runs — the chunks a model plane ships as single mega-rounds — yielding ``(lo, hi, key)`` with the run's shared
    ``bucket_key`` so dispatchers never re-derive it (one source for the
    (col_sparse, min_bucket) arguments).  Splitting (rather than padding to
    the horizon max) means no round ever pays a larger shape bucket than its
    own single-dispatch bucket; in the steady regime keys rarely change, so
    chunks stay horizon-length.
    """
    lo = 0
    while lo < len(plans):
        key = bucket_key(plans[lo], n_workers, col_sparse, min_bucket,
                         mesh_shards)
        hi = lo + 1
        while (hi < len(plans)
               and bucket_key(plans[hi], n_workers, col_sparse,
                              min_bucket, mesh_shards) == key):
            hi += 1
        yield lo, hi, key
        lo = hi


class HorizonPlanner:
    """Replays ``Mechanism`` control-plane bookkeeping to produce
    ``PlannedRound``s.

    Owns ALL mutable control-plane state (staleness, pull counts, readiness
    clocks, failure mask, simulated clock, comm accounting); the simulator
    only reads it back for history records.  ``net`` is duck-typed: anything
    with ``.dist`` and ``.link_rates()`` (see ``dfl.network.EdgeNetwork``).

    The planner drives ANY ``Mechanism`` subclass — DySTop (WAA + PTCA) and
    every Table-I comparison mechanism (``core.baselines``: MATCHA, AsyDFL,
    SA-ADFL, GossipFL) — under one rng discipline and one accounting model,
    which is what makes the baseline arena (``benchmarks/arena.py``)
    apples-to-apples:

    * rng: per round, the draw order is failure draws → the mechanism's own
      ``ctx.rng`` draws → channel sampling.  A mechanism may consume any
      number of draws (MATCHA draws once per matching, GossipFL once per
      worker, DySTop none) — the stream position after the round is a pure
      function of the stream before it, so trajectories replay bit-for-bit
      at any horizon, on any engine, at any shard count.
    * synchrony: ``RoundDecision.synchronous`` selects the cost model —
      sync rounds (MATCHA, GossipFL) pay every worker's FULL retrain plus
      the stall+retry ceiling ``sync_link_timeout_s`` (a barrier cannot
      abort a pull); async rounds pay only activated workers' compute
      remainders with the graceful ``link_timeout_s`` abort ceiling.
    * accounting: Eq. 9 durations, Eq. 10 transfer counts, and
      ``comm_bytes = Σ n_transfers · model_bytes`` come from the SAME code
      path for every mechanism — a mechanism only decides ``active`` and
      ``links``.
    * dispatch: the model plane chunks plans at ``bucket_key`` changes
      (``chunk_spans``), so each mechanism flushes at its natural bucket
      boundaries — all-active sync rounds stay horizon-length at the
      ``k = N`` bucket, SA-ADFL's varying neighborhood sizes split where
      the activation-set bucket actually moves.
    """

    def __init__(self, mechanism: Mechanism, *, h_i: np.ndarray,
                 in_range: np.ndarray, exp_link_time: np.ndarray,
                 model_bytes: float, class_counts: np.ndarray,
                 data_sizes: np.ndarray, net, rng: np.random.Generator,
                 tau_bound: int, bandwidth_budget: float,
                 link_timeout_s: float, sync_link_timeout_s: float,
                 failure_prob: float = 0.0, failure_persist: float = 0.5,
                 mesh_shards: int = 1, scenario=None):
        n = len(h_i)
        self.mechanism = mechanism
        self.n_workers = n
        self.h_i = h_i
        self.in_range = in_range
        self.exp_link_time = exp_link_time
        self.model_bytes = model_bytes
        self.class_counts = class_counts
        self.data_sizes = data_sizes
        self.net = net
        self.rng = rng
        self.link_timeout_s = link_timeout_s
        self.sync_link_timeout_s = sync_link_timeout_s
        self.failure_prob = failure_prob
        self.failure_persist = failure_persist
        # scenario plane (core.scenarios.CompiledScenario or None): timed
        # fault overlays composed on TOP of the stochastic dynamics.  Every
        # overlay is a deterministic post-transform of this round's state —
        # it never consumes or reorders rng draws, so a scenario replays
        # bit-identically at any horizon, engine, or shard count, and the
        # no-scenario trajectory is untouched.
        self.scenario = scenario
        # shard-aware chunking: with a mesh-sharded model plane the planner
        # resolves mixing-column unions (and therefore bucket keys) against
        # the shard layout, so padding rows stay shard-local at dispatch time;
        # mesh_shards=1 reproduces the unsharded plans bit-for-bit.  Purely a
        # dispatch-shape concern — the control rng stream never sees it.
        self.mesh_shards = mesh_shards
        # mutable control state
        self.st = StalenessState.create(n, tau_bound)
        self.pull_counts = np.zeros((n, n), np.float64)
        self.time_since_act = np.zeros(n, np.float64)
        self.budget = np.full(n, bandwidth_budget, np.float64)
        self.down = np.zeros(n, bool)
        self.t = 0
        self.sim_clock = 0.0
        self.comm_bytes = 0.0

    def plan_round(self) -> PlannedRound:
        """Advance the control plane by one round (Alg. 1 host half)."""
        rng = self.rng
        n = self.n_workers
        self.t += 1
        t = self.t

        # scenario overlay for THIS round: resolved before any rng draw so a
        # rejoiner's staleness reset is visible to the mechanism, but the
        # overlay itself is rng-free — the stochastic draws below are
        # identical with and without a scenario.
        ov = self.scenario.overlay(t) if self.scenario is not None else None
        if ov is not None and ov.rejoined is not None:
            # churned-back worker re-syncs before participating: fresh
            # staleness clock + drained Eq. 33 queue (StalenessState.reset)
            self.st.reset(ov.rejoined)

        # edge dynamics: workers fail and rejoin (paper's "Edge Dynamic" axis)
        if self.failure_prob > 0:
            self.down = ((self.down
                          & (rng.random(n) < self.failure_persist))
                         | (~self.down
                            & (rng.random(n) < self.failure_prob)))
        down = self.down
        in_range = self.in_range
        if ov is not None:
            if ov.forced_down is not None:
                down = down | ov.forced_down      # churn rides the same mask
            if ov.link_ok is not None:
                in_range = in_range & ov.link_ok  # blackout / mobility window
        up_range = in_range & ~down[None, :] & ~down[:, None]

        # straggler windows stretch local compute deterministically
        h_i = self.h_i if ov is None or ov.compute_scale is None \
            else self.h_i * ov.compute_scale

        # per-round costs (Eq. 7-8 estimate for the coordinator)
        h_cmp = np.maximum(h_i - self.time_since_act, 0.0)
        est_com = np.where(up_range, self.exp_link_time, 0.0).max(axis=1)
        round_cost = h_cmp + est_com

        ctx = RoundContext(
            t=t, round_cost=round_cost,
            readiness=h_i - self.time_since_act, in_range=up_range,
            class_counts=self.class_counts, phys_dist=self.net.dist,
            pull_counts=self.pull_counts, staleness=self.st,
            bandwidth_budget=self.budget, data_sizes=self.data_sizes, rng=rng,
            base_in_range=self.in_range)
        dec = self.mechanism.round(ctx)
        if self.failure_prob > 0 or (ov is not None
                                     and ov.forced_down is not None):
            # a down worker can neither train nor serve pulls this round
            dec.active = dec.active & ~down
            dec.links = dec.links & ~down[None, :] & ~down[:, None]
        if ov is not None and ov.link_ok is not None:
            # blacked-out links are unusable even between up workers —
            # mechanisms with cached plans (e.g. MATCHA matchings) can still
            # propose them.  A worker whose neighbors are ALL masked degrades
            # to its identity mixing row (self-weight 1): graceful, no stall.
            dec.links = dec.links & ov.link_ok

        # actual round duration with sampled (dynamic) channels: the sparse
        # row-max route consumes the identical rng draws as the dense
        # link_rates() but only transforms the round's actual link entries
        raw_com = self.net.sample_link_row_max(
            self.model_bytes, dec.links,
            rate_scale=None if ov is None else ov.rate_scale)
        if dec.synchronous:
            # a synchronous barrier cannot abort a pull: the aggregation needs
            # every matched neighbor's model, so deep fades stall the whole
            # round until retransmission succeeds (the straggler/dynamics cost
            # the paper measures) — bounded by the stall+retry ceiling
            com_part = np.minimum(raw_com, self.sync_link_timeout_s)
            cmp_part = h_i                                 # full retrain (sync)
            eligible = np.ones(n, bool)
        else:
            # async pulls degrade gracefully: abort/retry ceiling
            com_part = np.minimum(raw_com, self.link_timeout_s)
            cmp_part = h_cmp
            eligible = dec.active
        h_t_i = cmp_part + com_part                        # (N,)
        duration = float(h_t_i[eligible].max()) if eligible.any() else 0.0

        # the Eq. 4 matrix and its non-identity row ids in one pass: the ids
        # ride on the PlannedRound so dispatch-side packers (pack_horizon /
        # pack_chunk) never re-derive the row mask the planner already built
        W, mix_rows = mixing_matrix_rows(dec.active, dec.links,
                                         self.data_sizes)
        # row sets + bucket-padding candidates resolved here too: the
        # pipelined packer's inner loop is then pure gathers/assignments
        train_rows = np.flatnonzero(dec.active)
        mix_mask = np.zeros(len(dec.active), bool)
        mix_mask[mix_rows] = True
        mix_pad = np.flatnonzero(~mix_mask)[:1]
        train_pad = np.flatnonzero(~dec.active)[:1]

        # bookkeeping (Eqs. 6, 10, 33) — model-value-independent, so it can
        # run arbitrarily far ahead of the device
        n_transfers = int(dec.links.sum())
        self.sim_clock += duration
        self.comm_bytes += n_transfers * self.model_bytes
        self.pull_counts += dec.links
        self.time_since_act += duration
        self.time_since_act[dec.active] = 0.0
        self.st.advance(dec.active)

        return PlannedRound(t=t, active=dec.active, links=dec.links,
                            synchronous=dec.synchronous, W=W,
                            duration=duration, n_transfers=n_transfers,
                            mix_cols=col_union_mask(dec.active, dec.links,
                                                    self.mesh_shards),
                            mix_rows=mix_rows, train_rows=train_rows,
                            mix_pad=mix_pad, train_pad=train_pad)

    def plan(self, horizon: int,
             max_round: Optional[int] = None) -> List[PlannedRound]:
        """Plan up to ``horizon`` rounds (stopping at round ``max_round``)."""
        plans: List[PlannedRound] = []
        while len(plans) < horizon and (max_round is None
                                        or self.t < max_round):
            plans.append(self.plan_round())
        return plans

    # -- checkpoint/resume ---------------------------------------------------
    # The planner owns ALL mutable control-plane state, so these two methods
    # are the complete control half of a crash-safe snapshot: restoring them
    # into a freshly-constructed planner (same config, same seed-derived
    # static inputs) makes the next plan_round() bit-identical to the round
    # the original run would have planned.  The rng state is the numpy
    # BitGenerator state dict — plain ints/strs, so it survives a JSON
    # round-trip through checkpoint metadata exactly.
    #
    # Pipeline-depth semantics: the drive loops NEVER plan past a snapshot
    # boundary (checkpoint rounds force a flush + pipeline drain before
    # save_snapshot runs), so at snapshot time ``self.t`` equals the last
    # DISPATCHED round and state_dict() needs no in-flight plan queue —
    # resuming a pipelined run replays from the exact same stream position as
    # a lockstep one.  That invariant is what keeps pipeline_depth out of the
    # checkpoint format (see dfl.pipeline).

    _STATE_ARRAYS = ("tau", "queue", "pull_counts", "time_since_act",
                     "budget", "down")

    def state_dict(self) -> dict:
        """Snapshot every mutable control-plane field (copies, not views)."""
        return {
            "arrays": {
                "tau": self.st.tau.copy(),
                "queue": self.st.queue.copy(),
                "pull_counts": self.pull_counts.copy(),
                "time_since_act": self.time_since_act.copy(),
                "budget": self.budget.copy(),
                "down": self.down.copy(),
            },
            "scalars": {"t": int(self.t),
                        "sim_clock": float(self.sim_clock),
                        "comm_bytes": float(self.comm_bytes)},
            "rng_state": self.rng.bit_generator.state,
        }

    def load_state(self, state: dict) -> None:
        """Restore a ``state_dict()`` snapshot (dtype-exact: the arrays stay
        host numpy, int64 and float64 as the planner keeps them)."""
        a = state["arrays"]
        self.st.tau = np.asarray(a["tau"], np.int64).copy()
        self.st.queue = np.asarray(a["queue"], np.float64).copy()
        self.pull_counts = np.asarray(a["pull_counts"], np.float64).copy()
        self.time_since_act = np.asarray(a["time_since_act"],
                                         np.float64).copy()
        self.budget = np.asarray(a["budget"], np.float64).copy()
        self.down = np.asarray(a["down"], bool).copy()
        s = state["scalars"]
        self.t = int(s["t"])
        self.sim_clock = float(s["sim_clock"])
        self.comm_bytes = float(s["comm_bytes"])
        self.rng.bit_generator.state = state["rng_state"]

"""The paper's comparison mechanisms (Table I / section VI-A3), on the same
planner-driven round engine as DySTop so completion-time and communication
accounting are apples-to-apples (the port of ``repro.core.baselines``; every
``ctx.rng`` draw is made in the same order and count, so a trajectory is the
JAX package's bit for bit).

* MATCHA  [9]  — synchronous; matching decomposition of the base graph,
                 subgraphs sampled each round.  Paper treats it as the
                 communication lower bound among benchmarks.
* AsyDFL  [14] — asynchronous; finished-workers activate, random neighbor
                 subset; NO staleness control.
* SA-ADFL [15] — asynchronous; dynamic staleness control but activates ONE
                 worker per round and pushes its model to ALL in-range
                 neighbors (the overhead DySTop removes).
* GossipFL[7]  — synchronous sparsified gossip: one peer per worker per round.

The planner-compat contract every ``Mechanism`` here satisfies (what lets
``core.planner.HorizonPlanner`` replay it arbitrarily far ahead of the device
and the engine execute it as mega-rounds):

1. ``round(ctx)`` reads ONLY ``RoundContext`` scalars — never model values.
2. All randomness comes from ``ctx.rng``, drawn in a deterministic order (the
   draw count may depend on prior control state but never on anything
   outside the ctx) — the stream position IS the trajectory, so one round's
   decisions replay bit-for-bit at any horizon, engine, or shard count.
3. One-time structural preprocessing keys on STATIC inputs
   (``ctx.base_in_range``, ``ctx.class_counts``, ``ctx.phys_dist``), never on
   the failure-masked instantaneous ``ctx.in_range`` — the planner masks the
   returned decisions against down workers and scenario overlays afterwards.
4. ``RoundDecision.synchronous`` declares the cost model: sync rounds price
   every worker's full retrain + the ``sync_link_timeout_s`` stall ceiling;
   async rounds price activated compute remainders + the ``link_timeout_s``
   abort ceiling (planner Eqs. 7-9, simulated seconds).
5. ``links[i, j]`` means "i mixes in j's model this round"; every link is one
   model transfer in the Eq. 10 accounting (``comm_bytes += n_transfers · b``,
   bytes).  Workers that mix must appear in ``active`` iff they also train
   (``core.planner.mix_is_train`` feeds the fused mix→train path).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.protocol import (DySTop, Mechanism, RoundContext,
                                       RoundDecision)


def _matching_decomposition(adj: np.ndarray, rng: np.random.Generator
                            ) -> List[np.ndarray]:
    """Greedy edge-coloring of the undirected base graph into matchings."""
    n = adj.shape[0]
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if adj[i, j]]
    rng.shuffle(edges)
    matchings: List[List[tuple]] = []
    for (i, j) in edges:
        placed = False
        for m in matchings:
            if all(i not in e and j not in e for e in m):
                m.append((i, j))
                placed = True
                break
        if not placed:
            matchings.append([(i, j)])
    out = []
    for m in matchings:
        a = np.zeros((n, n), bool)
        for (i, j) in m:
            a[i, j] = a[j, i] = True
        out.append(a)
    return out


class MATCHA(Mechanism):
    """MATCHA [9]: synchronous matching-based decentralized SGD.

    The base communication graph is decomposed ONCE into disjoint matchings
    (greedy edge coloring, seeded independently of the round stream); each
    round every matching is kept with probability ``activation_ratio`` and
    the union of kept matchings is that round's topology.  Every worker
    trains every round (``synchronous=True``: the planner prices the full
    local retrain ``h_i`` of ALL workers plus the sync stall ceiling — the
    straggler cost the paper measures).

    Planner compat: the decomposition keys on the STATIC base graph
    (``ctx.base_in_range``; the instantaneous ``ctx.in_range`` is failure-
    masked and varies round to round).  The cache compares by identity, like
    ``DySTop._phase1_priority``, so one instance can be reused across
    simulations without serving a stale decomposition.  Per round it draws
    exactly ``len(matchings)`` Bernoulli variates from ``ctx.rng`` — a
    deterministic count, keeping the shared stream bit-replayable.  Links
    into down/blacked-out workers are masked by the planner afterwards.
    """
    name = "matcha"

    def __init__(self, activation_ratio: float = 0.5, seed: int = 0):
        self.cb = activation_ratio
        self._matchings: Optional[List[np.ndarray]] = None
        self._base_key = None           # identity of the graph decomposed
        self._seed = seed

    def round(self, ctx: RoundContext) -> RoundDecision:
        base = ctx.base_in_range if ctx.base_in_range is not None \
            else ctx.in_range
        if self._matchings is None or self._base_key is not base:
            rng = np.random.default_rng(self._seed)
            self._matchings = _matching_decomposition(base, rng)
            self._base_key = base
        n = len(ctx.round_cost)
        links = np.zeros((n, n), bool)
        for m in self._matchings:
            if ctx.rng.random() < self.cb:
                links |= m
        # synchronous: every worker aggregates + trains every round
        return RoundDecision(active=np.ones(n, bool), links=links,
                             synchronous=True)


class GossipFL(Mechanism):
    """GossipFL [7]: synchronous sparsified gossip.

    Each worker picks ONE in-range peer per round (uniform via ``ctx.rng``,
    one draw per worker with any candidate — deterministic order, index-
    ascending) and mixes that single model in: N transfers per round, the
    sparsest synchronous topology in the arena.  ``synchronous=True`` prices
    the full-fleet retrain + sync stall ceiling, as with MATCHA.
    """
    name = "gossipfl"

    def round(self, ctx: RoundContext) -> RoundDecision:
        n = len(ctx.round_cost)
        links = np.zeros((n, n), bool)
        for i in range(n):
            cand = np.flatnonzero(ctx.in_range[i])
            if len(cand):
                links[i, ctx.rng.choice(cand)] = True
        return RoundDecision(active=np.ones(n, bool), links=links,
                             synchronous=True)


class AsyDFL(Mechanism):
    """AsyDFL [14]: asynchronous, NO staleness control.

    The ``max(1, frac_activate·N)`` workers whose background local training
    finished earliest (FIFO over ``ctx.readiness`` — most negative = done
    longest ago, stable sort for deterministic ties) activate and each pulls
    from ``n_neighbors`` random in-range peers (one ``ctx.rng.choice`` per
    activated worker, index-ascending order).  Uncontrolled asynchrony is
    the ablation axis: staleness grows unboundedly on slow workers, which is
    exactly what the scenario degradation table measures.
    """
    name = "asydfl"

    def __init__(self, n_neighbors: int = 7, frac_activate: float = 0.1):
        self.s = n_neighbors
        self.frac = frac_activate

    def round(self, ctx: RoundContext) -> RoundDecision:
        n = len(ctx.round_cost)
        k = max(1, int(self.frac * n))
        active = np.zeros(n, bool)
        # FIFO over finish times: the workers whose background training
        # completed earliest aggregate next (no staleness control)
        active[np.argsort(ctx.readiness, kind="stable")[:k]] = True
        links = np.zeros((n, n), bool)
        for i in np.flatnonzero(active):
            cand = np.flatnonzero(ctx.in_range[i])
            if len(cand):
                pick = ctx.rng.choice(cand, size=min(self.s, len(cand)),
                                      replace=False)
                links[i, pick] = True
        return RoundDecision(active=active, links=links)


class SAADFL(Mechanism):
    """SA-ADFL [15]: staleness-aware activation of a SINGLE worker per round,
    which pulls from and pushes to ALL in-range neighbors (paper section
    II-C) — the per-round neighborhood flood whose transfer overhead DySTop's
    PTCA removes.

    Activation is the Eq. 34 drift-plus-penalty objective restricted to
    singleton sets: activating {i} scores ``const − q_i·(τ_i + 1) + V·H_t^i``,
    so the staleness-aware pick maximizes the queue pressure net of cost,

        i* = argmax_i  q_i · (τ_i + 1) − V · H_t^i .

    (The WAA prefix scan is the WRONG tool here: prefixes of the cost-sorted
    order capped at length 1 can only ever yield the globally cheapest
    worker, which starves every neighborhood the cheapest workers don't
    touch — the arena's non-IID cells then stall far below target.  The
    singleton rule is the faithful "dynamic staleness control" of [15]: a
    neglected worker's virtual queue grows superlinearly until it wins.)
    Ties break to the lowest index (numpy argmax), deterministically.

    Receivers integrate the pushed model and materialize their own update,
    so they are marked active too — mix rows equal train rows
    (``core.planner.mix_is_train`` holds) and the fused engine feeds Eq. 4
    straight into Eq. 5.  Draws nothing from ``ctx.rng``.
    """
    name = "sa-adfl"

    def __init__(self, V: float = 10.0):
        self.V = V

    def round(self, ctx: RoundContext) -> RoundDecision:
        n = len(ctx.round_cost)
        st = ctx.staleness
        pressure = st.queue * (st.tau + 1.0) - self.V * ctx.round_cost
        w = int(np.argmax(pressure))
        active = np.zeros(n, bool)
        active[w] = True
        links = np.zeros((n, n), bool)
        neigh = np.flatnonzero(ctx.in_range[w])
        links[w, neigh] = True          # pull from all neighbors
        links[neigh, w] = True          # push to all neighbors (they mix it in)
        # receivers integrate the pushed model and continue their own local
        # training (SA-ADFL workers train continuously; the push triggers the
        # update materialization on their side too)
        active[neigh] = True
        return RoundDecision(active=active, links=links)


def get_mechanism(name: str, **kw) -> Mechanism:
    """Construct a Table-I mechanism by its arena name.

    Names: ``dystop`` | ``matcha`` | ``gossipfl`` | ``asydfl`` | ``sa-adfl``.
    ``**kw`` forwards to the constructor (e.g. ``V=``/``t_thre=``/
    ``max_neighbors=`` for DySTop, ``n_neighbors=`` for AsyDFL).  Every
    returned instance satisfies the planner-compat contract in the module
    docstring; construct a FRESH instance per simulation unless you rely on
    the identity-keyed caches (DySTop phase-1 priority, MATCHA matchings)
    re-deriving on a new environment.
    """
    table = {"dystop": DySTop, "matcha": MATCHA, "gossipfl": GossipFL,
             "asydfl": AsyDFL, "sa-adfl": SAADFL}
    return table[name](**kw)

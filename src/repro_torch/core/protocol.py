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

``dystop_pod_mix`` is the data plane of pods as workers: Eq. 4 across whole
model replicas (``launch/steps.py::make_dystop_round_step`` trains them).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ptca as PT
from repro_torch.core import waa as WA
from repro_torch.core.staleness import StalenessState
from repro_torch.kernels import aggregate as AGG
from repro_torch.tree import tree_from_paths, tree_paths


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


# --------------------------------------------------------------------------- #
# production plane: pods as DFL workers
# --------------------------------------------------------------------------- #

def pod_sharding(mesh, n_pods: int):
    """The pod axis of ``n_pods`` partitioned over ``mesh``
    (``sharding.rules.FleetSharding``; its ``home`` is this rank's
    contiguous block of pods), or None without a mesh or on a mesh of one
    shard (this process holds every pod).  The shard count must divide
    ``n_pods``."""
    if mesh is None or mesh.n_shards == 1:
        return None
    from repro_torch.sharding.rules import FleetSharding
    shd = FleetSharding(mesh, n_pods)
    if shd.pad:
        raise ValueError(f"pods as workers: {mesh.n_shards} ranks do not "
                         f"divide {n_pods} pods")
    return shd


def dystop_pod_mix(params, W, mesh=None):
    """Weighted cross-pod aggregation (Eq. 4 with pods as DFL workers).

    ``params`` is a tree whose leaves carry a leading pod axis: all
    ``n_pods`` replicas without a mesh (``mesh=None`` or a
    ``launch.mesh.FleetMesh`` of one shard: the JAX package's stacked
    tree), else this rank's contiguous block of ``n_pods / S`` pods
    (``pod_sharding``; one pod a rank is the reference's ``shard_map``
    view).
    ``W`` is the (n_pods, n_pods) row-stochastic mixing matrix from the
    host coordinator (numpy or a tensor).  Returns a new tree of the same
    leaves, each in its own dtype (``tree_from_paths``: empty subtrees are
    dropped, as a train step's output drops them).

    Each pod's leaves are flattened, in ``tree_paths`` order, into one f32
    row of a (n_pods, P) buffer (bf16 to f32 is exact); the rows of the
    other ranks are all-gathered into it
    (``FleetSharding.all_gather_rows``; no collective on one process), and
    the block's rows of W are applied by the Eq. 4 ``aggregate`` kernel
    (``Y = W[lo:hi] @ X``), then cast back to each leaf's dtype.  That is
    one collective and one launch a round where the JAX package
    makes one of each per leaf.  Every row is mixed, identity rows too, as
    in the JAX package: an identity row gives its pod back unchanged
    unless a peer holds an inf or a NaN.  ``aggregate`` sums over the pods
    in order for each output on its own, so the stacked and the rank forms
    give the same bits."""
    paths = tree_paths(params)
    leaves = [leaf for _, leaf in paths]
    block = leaves[0].shape[0]
    n_pods = block * (1 if mesh is None else mesh.n_shards)
    shd = pod_sharding(mesh, n_pods)
    lo, hi = (0, n_pods) if shd is None else shd.home
    W = torch.as_tensor(W, dtype=torch.float32)
    if tuple(W.shape) != (n_pods, n_pods):
        raise ValueError(f"dystop_pod_mix: W is {tuple(W.shape)}, "
                         f"expected ({n_pods}, {n_pods})")
    dev = leaves[0].device
    sizes = [leaf[0].numel() for leaf in leaves]
    X = torch.empty((n_pods, sum(sizes)), dtype=torch.float32, device=dev)
    offsets, off = {}, 0
    for (path, leaf), n in zip(paths, sizes):
        if leaf.shape[0] != block:
            raise ValueError(f"dystop_pod_mix: leaf {path} has "
                             f"{leaf.shape[0]} pods, expected {block}")
        X[lo:hi, off:off + n].copy_(leaf.reshape(block, n))
        offsets[path] = (off, n)
        off += n
    if shd is not None:
        shd.all_gather_rows(X)
    Y = AGG.aggregate(W[lo:hi].to(dev).contiguous(), X)
    del X
    out = []
    for path, leaf in paths:
        o, n = offsets[path]
        new = torch.empty(leaf.shape, dtype=leaf.dtype, device=dev)
        new.view(block, n).copy_(Y[:, o:o + n])
        out.append((path, new))
    return tree_from_paths(out)

"""Logical-axis -> mesh-axis rules, and the fleet's row partition over the
mesh (``FleetSharding``): the port of ``repro.sharding.rules``.

Every parameter, batch input and cache leaf of the model zoo carries
*logical* axis names (``models.registry.param_axes``,
``batch_logical_axes``, ``launch.steps.cache_logical_axes``).
``logical_spec`` turns them into a ``PartitionSpec`` for a mesh
(``launch.mesh.Mesh``: axis names and sizes), dropping any mesh axis that
does not divide the tensor dimension evenly (smollm's 15 heads stay
replicated on a 16-way model axis) and using each mesh axis at most once
per tensor.  The rules are a plain dict (``DEFAULT_RULES``, the JAX
package's verbatim), overridable one rule at a time.  The spec is the
port's own tuple type; ``placements`` turns it into
``torch.distributed.tensor`` placements, the counterpart of
``NamedSharding``.  ``constrain`` is the identity outside a rules context
and on a mesh of one device; on a larger mesh it raises: no step runs
sharded over a (data, model) mesh yet (the sharded execution item, Queue A
item 9 of the roadmap).

The fleet half (``FleetSharding``, reference lines 181-237): under a fleet
mesh (``launch.mesh.make_fleet_mesh``) every rank
holds one contiguous block of the resident ``(N_pad, P)`` buffers: the
worker axis is zero-padded to a multiple of the shard count (the padding
rows are permanently idle: never activated, mixed or evaluated) and rank r
owns rows ``[r * block, (r + 1) * block)``.  Replicated operands are each
rank's own copy.  The JAX package's ``psum`` is ``psum`` here, an in-place
``dist.all_reduce``.  Its collectives report their bytes to an active
cost counter (``launch.loopcost``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.planner import shard_spans
from repro_torch.launch import loopcost as LC
from repro_torch.launch.mesh import FleetMesh, Mesh, make_fleet_mesh
from repro_torch.tree import tree_map

Rules = Dict[str, Optional[Tuple[str, ...]]]

# Default logical->mesh rules.  Values are tuples of mesh axis names (applied
# jointly to one tensor dim) or None (replicated).
DEFAULT_RULES: Rules = {
    # activations
    "data": ("pod", "data"),        # global batch
    "seq_act": ("data",),           # sequence-parallel activations / caches
    "embed_act": None,              # model-dim of activations: replicated
    "mlp_act": ("model",),
    "vocab_act": ("model",),
    "heads": ("model",),
    "q_seq": None,                  # context-parallel attention (perf override)
    "experts_act": ("model",),
    # params (fsdp over `data`, tensor-parallel over `model`; replicated over
    # `pod` — each pod is a DFL worker holding its own replica)
    "embed": ("data",),
    "mlp": ("model",),
    "vocab": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "experts": ("model",),
    "expert_mlp": ("model",),       # fallback TP inside experts (few-expert MoE)
    "expert_embed": ("data",),      # fsdp axis of expert weights (H2 knob)
    "moe_contract": None,           # dispatch-buffer d axis (H2: ('data',) =>
                                    #   co-sharded contraction, psum instead of
                                    #   weight all-gather)
    "expert_cap": ("model",),       # fallback for the dispatch buffer
    "moe_h_cap": ("model",),        # capacity dim of expert activations (H2:
                                    #   ('data',) turns the contraction psum
                                    #   into a reduce-scatter)
    "ssm_inner": ("model",),
    "ssm_state": None,
    "rnn_width": ("model",),
    "stack": None,                  # stacked-layer leading axis (scan layers)
    "worker": ("data",),            # DFL simulation: stacked worker axis
}


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (the dim split over them jointly, major to minor).  The
    counterpart of ``jax.sharding.PartitionSpec``; ``P(*entries)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class _Ctx:
    mesh: Mesh
    rules: Rules


_ACTIVE: Optional[_Ctx] = None


@contextlib.contextmanager
def use_sharding_rules(mesh: Mesh, overrides: Optional[Rules] = None):
    """Make ``mesh`` and the default rules (with ``overrides``) the active
    context of ``logical_spec`` and ``constrain`` for the dynamic extent."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, _Ctx(mesh, {**DEFAULT_RULES, **(overrides or {})})
    try:
        yield
    finally:
        _ACTIVE = prev


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE.mesh if _ACTIVE is not None else None


def _resolve_dim(logical: Optional[str], dim: int, mesh: Mesh, rules: Rules,
                 used: set):
    """Mesh axes for one tensor dim: skips axes already used by another dim
    of the same tensor and axes that don't divide the dim evenly."""
    axes = rules.get(logical) if logical is not None else None
    if not axes:
        return None
    sizes = mesh.shape
    picked = []
    divisor = 1
    for ax in axes:
        if ax not in sizes or ax in used:
            continue
        if dim % (divisor * sizes[ax]) == 0:
            picked.append(ax)
            divisor *= sizes[ax]
    if not picked:
        return None
    return tuple(picked) if len(picked) > 1 else picked[0]


def logical_spec(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh: Optional[Mesh] = None,
                 rules: Optional[Rules] = None) -> PartitionSpec:
    """The spec of a tensor with these logical axes and shape on ``mesh``
    (by default the active context's mesh and rules)."""
    if mesh is None:
        if _ACTIVE is None:
            raise ValueError("logical_spec: no mesh given and no active "
                             "sharding context (use_sharding_rules)")
        mesh = _ACTIVE.mesh
        rules = rules or _ACTIVE.rules
    rules = rules or DEFAULT_RULES
    # each mesh axis may be assigned to at most one dim of one tensor
    used: set = set()
    entries = []
    for logical, dim in zip(logical_axes, shape):
        r = _resolve_dim(logical, dim, mesh, rules, used)
        if r is not None:
            used.update(r if isinstance(r, tuple) else (r,))
        entries.append(r)
    return PartitionSpec(*entries)


def tree_shardings(logical_tree, shape_tree, mesh: Mesh,
                   rules: Optional[Rules] = None):
    """The spec of every leaf: a tree of logical-axes tuples and the
    matching tree of tensors (``meta`` ones will do) -> a tree of
    ``PartitionSpec``s."""
    return tree_map(lambda ax, t: logical_spec(ax, t.shape, mesh, rules),
                    logical_tree, shape_tree)


def placements(spec: PartitionSpec, mesh_dim_names: Sequence[str]) -> list:
    """``torch.distributed.tensor`` placements of ``spec`` on a device mesh
    whose dims are ``mesh_dim_names``: ``Shard(d)`` on each mesh dim that
    tensor dim d's entry names, ``Replicate()`` on the others.  A dim split
    over two mesh dims must name them in the mesh's order (major to minor,
    as JAX reads the tuple), which is how DTensor lays the blocks out."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh_dim_names]
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else entry or ()
        where = [list(mesh_dim_names).index(n) for n in names]
        if where != sorted(where):
            raise ValueError(f"placements: dim {d} splits over {names}, "
                             f"not in the mesh's order {tuple(mesh_dim_names)}")
        for m in where:
            out[m] = Shard(d)
    return out


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """``x`` itself outside a rules context and on a mesh of one device,
    where every spec is a no-op.  On a larger mesh there is no sharded
    step to constrain: it raises."""
    if _ACTIVE is None or _ACTIVE.mesh.n_devices == 1:
        return x
    raise NotImplementedError(
        f"constrain: sharded execution over a {dict(_ACTIVE.mesh.shape)} "
        f"mesh is not ported (Queue A item 9 of the roadmap); only a mesh "
        f"of one device runs")

_CHUNK = 1 << 26          # elements per collective call (256 MB in f32)


@dataclasses.dataclass(frozen=True)
class FleetSharding:
    """This rank's view of the fleet's ``n_rows`` workers partitioned over
    ``mesh`` (see module docstring)."""
    mesh: FleetMesh
    n_rows: int

    @classmethod
    def create(cls, mesh_shards: int, n_rows: int, device) -> "FleetSharding":
        """Join the fleet mesh (``launch.mesh.make_fleet_mesh``) and
        partition ``n_rows`` workers over it."""
        return cls(mesh=make_fleet_mesh(mesh_shards, device), n_rows=n_rows)

    @property
    def n_shards(self) -> int:
        return self.mesh.n_shards

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def pad(self) -> int:
        """Permanently idle rows that make the worker axis divisible."""
        return (-self.n_rows) % self.n_shards

    @property
    def n_pad(self) -> int:
        return self.n_rows + self.pad

    @property
    def block(self) -> int:
        """Rows each rank holds."""
        return self.n_pad // self.n_shards

    @property
    def home(self) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` rows of the padded worker axis."""
        return self.rank * self.block, (self.rank + 1) * self.block

    @property
    def n_home_real(self) -> int:
        """Rows of this rank's block that are real workers (not padding)."""
        lo, hi = self.home
        return max(0, min(hi, self.n_rows) - lo)

    def put_rows_padded(self, x) -> torch.Tensor:
        """This rank's block of ``x`` (leading axis ``n_rows``; a tensor or
        a numpy array), zero-padded to ``block`` rows, on its device."""
        lo, _ = self.home
        real = x[lo:lo + self.n_home_real]
        if isinstance(real, np.ndarray):
            real = torch.from_numpy(np.ascontiguousarray(real))
        out = torch.zeros((self.block,) + tuple(real.shape[1:]),
                          dtype=real.dtype, device=self.device)
        out[:len(real)] = real
        return out

    def for_rows(self, row_ids: np.ndarray) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` segment of a home-grouped gathered id
        vector (host ids, ``padded_rows(shards=...)`` layout): the rows it
        computes and scatters back locally."""
        return shard_spans(row_ids, self.n_rows, self.n_shards)[self.rank]

    def local(self, ids: torch.Tensor) -> torch.Tensor:
        """Global row ids of this rank's home rows -> rows of its block."""
        return ids.long() - self.home[0]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place (``dist.all_reduce``, in
        pieces of at most 2^26 elements); returns ``x``."""
        if not x.is_contiguous():
            raise ValueError("psum: the tensor must be contiguous")
        flat = x.view(-1)
        for piece in flat.split(_CHUNK):
            dist.all_reduce(piece)
        LC.collective("all-reduce", x.numel() * x.element_size())
        return x

    @property
    def _via(self) -> torch.device:
        """Where a gather's pieces travel: the rank's card over NCCL, host
        memory over gloo."""
        return (self.device if self.mesh.backend == "nccl"
                else torch.device("cpu"))

    def gather_rows(self, block: torch.Tensor,
                    device=None) -> Optional[torch.Tensor]:
        """Assemble the ``(n_rows, C)`` buffer from every rank's ``(block,
        C)`` block: rank 0 gets it on ``device`` (its own by default), the
        others None; the padding rows are left out.  Gloo gathers through
        host memory, in column pieces of at most 2^26 elements per rank."""
        rows, cols = block.shape
        via = self._via
        dest = self.device if device is None else torch.device(device)
        full = (torch.empty((self.n_rows, cols), dtype=block.dtype,
                            device=dest) if self.rank == 0 else None)
        step = max(1, _CHUNK // max(rows, 1))
        for c0 in range(0, cols, step):
            piece = block[:, c0:c0 + step].to(via).contiguous()
            parts = ([torch.empty_like(piece) for _ in range(self.n_shards)]
                     if self.rank == 0 else None)
            dist.gather(piece, parts, dst=0)
            LC.collective("gather", piece.numel() * piece.element_size())
            if full is not None:
                full[:, c0:c0 + step] = torch.cat(parts)[:self.n_rows].to(
                    dest)
        return full

    def all_gather_rows(self, full: torch.Tensor) -> torch.Tensor:
        """Fill the other ranks' rows of the ``(n_pad, C)`` buffer ``full``,
        in place, from each rank's home rows (``dist.all_gather``: every
        rank gets every row).  Gloo gathers through host memory, in column
        pieces of at most 2^26 elements per rank; returns ``full``."""
        lo, hi = self.home
        step = max(1, _CHUNK // self.block)
        for c0 in range(0, full.shape[1], step):
            piece = full[lo:hi, c0:c0 + step].to(self._via).contiguous()
            parts = [torch.empty_like(piece) for _ in range(self.n_shards)]
            dist.all_gather(parts, piece)
            LC.collective("all-gather", piece.numel() * piece.element_size()
                          * self.n_shards)
            for r, part in enumerate(parts):
                if r != self.rank:
                    full[r * self.block:(r + 1) * self.block,
                         c0:c0 + step].copy_(part)
        return full

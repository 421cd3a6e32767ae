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
``NamedSharding``.

Sharded execution (explicit SPMD): under ``use_sharding_rules`` with one
rank's place on a mesh of ranks (``launch.mesh.make_rank_mesh``, or a
``rank_view`` on ``meta``), each rank holds its local block of every
leaf (``local_slice``: JAX's block order, major to minor) and the model
code says where data moves, with autograd-aware collectives over named
axes: ``all_gather`` (backward: a reduce-scatter, or the rank's own
block where the cotangent is replicated), ``psum`` (backward: the
cotangent as it comes), ``psum_grad`` (the identity; backward: a psum)
and ``local_block`` (backward: an all-gather).  ``constrain`` brings a
local tensor to a logical layout: it reduces a pending partial sum,
gathers a dim the layout no longer splits and slices one it splits.  It
is the identity outside a rules context and on a mesh of one device.
Only the families in ``SHARDED_FAMILIES`` run sharded (the step builders,
``launch.steps``, refuse the rest: item 9(b) of the roadmap).  The
collectives run in pieces of at most ``_CHUNK`` elements, through host
memory on gloo, and report their result bytes to an active cost counter
(``launch.loopcost.collective``); on ``meta`` they only shape their
outputs.  ``gather_params`` is FSDP's gather of a layer's leaves over the
batch axes (``"data"``, ``"pod"``); ``"model"`` (``TP_AXIS``) stays split
in the compute.

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


TP_AXIS = "model"                   # the tensor-parallel axis
SHARDED_FAMILIES = ("dense",)       # families whose step runs on a rank mesh


@dataclasses.dataclass(frozen=True)
class _Ctx:
    mesh: Mesh
    rules: Rules


_ACTIVE: Optional[_Ctx] = None


@contextlib.contextmanager
def use_sharding_rules(mesh: Mesh, overrides: Optional[Rules] = None):
    """Make ``mesh`` and the default rules (with ``overrides``) the active
    context of ``logical_spec``, ``constrain`` and the collectives for the
    dynamic extent."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, _Ctx(mesh, {**DEFAULT_RULES, **(overrides or {})})
    try:
        yield
    finally:
        _ACTIVE = prev


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE.mesh if _ACTIVE is not None else None


def active_rules() -> Rules:
    return _ACTIVE.rules if _ACTIVE is not None else DEFAULT_RULES


def rank_mesh() -> Optional[Mesh]:
    """The active mesh where it is one rank's place on a mesh of more than
    one device (the model code then runs sharded), else None."""
    if _ACTIVE is not None and _ACTIVE.mesh.ranked:
        return _ACTIVE.mesh
    return None


def batch_axes(mesh: Optional[Mesh] = None,
               rules: Optional[Rules] = None) -> Tuple[str, ...]:
    """The mesh axes of more than one device that split the global batch
    (the ``"data"`` rule's), major to minor."""
    mesh = mesh or active_mesh()
    rules = rules or active_rules()
    return tuple(a for a in rules.get("data") or ()
                 if mesh is not None and mesh.size(a) > 1)


def batch_split(mesh: Optional[Mesh] = None) -> int:
    """How many blocks the batch axes cut the global batch into."""
    mesh = mesh or active_mesh()
    return int(np.prod([mesh.size(a) for a in batch_axes(mesh)]))


def batch_entry(mesh: Optional[Mesh] = None):
    """The spec entry of a dim split over the batch axes."""
    axes = batch_axes(mesh)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def axis_names(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes, major to minor (() for None)."""
    return _names(entry)


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


def _names(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _split(entry, mesh: Mesh) -> int:
    return int(np.prod([mesh.size(a) for a in _names(entry)]))


def _block_index(entry, mesh: Mesh) -> int:
    """This rank's block of a dim split over ``entry`` (major to minor)."""
    i = 0
    for a in _names(entry):
        i = i * mesh.size(a) + mesh.coord(a)
    return i


def global_shape(shape: Sequence[int], spec: PartitionSpec,
                 mesh: Mesh) -> Tuple[int, ...]:
    """The global shape of a rank's local block ``shape`` laid out by
    ``spec``."""
    return tuple(n * _split(e, mesh) for n, e in
                 zip(shape, tuple(spec) + (None,) * len(shape)))


def local_slice(t: torch.Tensor, spec: PartitionSpec,
                mesh: Mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` laid out by ``spec``
    on ``mesh`` (a view; JAX's block order: a dim split over several axes
    is cut major to minor)."""
    for d, entry in enumerate(spec):
        n = _split(entry, mesh)
        if n > 1:
            size = t.shape[d] // n
            t = t.narrow(d, _block_index(entry, mesh) * size, size)
    return t


def local_tree(tree, specs, mesh: Mesh):
    """``local_slice`` of every leaf of ``tree`` by the matching spec."""
    return tree_map(lambda t, s: local_slice(t, s, mesh), tree, specs)


# --------------------------------------------------------------------------- #
# collectives over named axes
# --------------------------------------------------------------------------- #

_CHUNK = 1 << 26          # elements per collective call (256 MB in f32)


def _mesh_axes(axes) -> Tuple[str, ...]:
    """The axes of the active rank mesh, of more than one device, among
    ``axes`` (a name or a tuple, major to minor)."""
    mesh = rank_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in _names(axes) if mesh.size(a) > 1)


def _via(mesh: Mesh) -> torch.device:
    """Where a collective's pieces travel: the rank's card over NCCL, host
    memory over gloo (which all-gathers no CUDA tensor)."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def _reduce(x: torch.Tensor, axis: str, mesh: Mesh, op=None
            ) -> torch.Tensor:
    """A new tensor: the sum (or ``op``) of ``x`` over the ranks of
    ``axis``."""
    with LC.paused():
        if x.device.type == "meta":
            out = torch.empty_like(x)
        else:
            flat = x.detach().to(_via(mesh), copy=True).contiguous().view(-1)
            for piece in flat.split(_CHUNK):
                dist.all_reduce(piece, op=op or dist.ReduceOp.SUM,
                                group=mesh.groups[axis])
            out = flat.view(x.shape).to(x.device)
    LC.collective("all-reduce", x.numel() * x.element_size(), out)
    return out


def _gather(x: torch.Tensor, axis: str, dim: int, mesh: Mesh
            ) -> torch.Tensor:
    """The ranks of ``axis``' blocks of x concatenated along ``dim`` in
    rank order."""
    n = mesh.size(axis)
    with LC.paused():
        shape = list(x.shape)
        shape[dim] *= n
        if x.device.type == "meta":
            out = x.new_empty(shape)
        else:
            flat = x.detach().to(_via(mesh)).contiguous().view(-1)
            parts = [torch.empty_like(flat) for _ in range(n)]
            for off in range(0, flat.numel(), _CHUNK):
                dist.all_gather([p[off:off + _CHUNK] for p in parts],
                                flat[off:off + _CHUNK],
                                group=mesh.groups[axis])
            out = torch.cat([p.view(x.shape) for p in parts], dim).to(
                x.device)
    LC.collective("all-gather", out.numel() * out.element_size(), out)
    return out


def _block(x: torch.Tensor, axis: str, dim: int, mesh: Mesh
           ) -> torch.Tensor:
    """This rank's block of x along ``dim`` over ``axis`` (no traffic)."""
    size = x.shape[dim] // mesh.size(axis)
    return x.narrow(dim, mesh.coord(axis) * size, size).contiguous()


def _reduce_scatter(x: torch.Tensor, axis: str, dim: int, mesh: Mesh
                    ) -> torch.Tensor:
    """The sum of x over the ranks of ``axis``, this rank's block along
    ``dim``: ``reduce_scatter_tensor`` over NCCL; over gloo, which has no
    reduce-scatter of CUDA tensors, an all-reduce and then the block
    (counted as the reduce-scatter it stands for)."""
    n = mesh.size(axis)
    with LC.paused():
        if x.device.type == "meta":
            shape = list(x.shape)
            shape[dim] //= n
            out = x.new_empty(shape)
        elif mesh.backend == "nccl":
            # blocks along dim 0, each a row of (n, block numel)
            rows = x.detach().movedim(dim, 0).contiguous()
            out = rows.new_empty((rows.shape[0] // n,) + rows.shape[1:])
            flat, part = rows.view(n, -1), out.view(-1)
            for off in range(0, part.numel(), _CHUNK):
                dist.reduce_scatter_tensor(
                    part[off:off + _CHUNK],
                    flat[:, off:off + _CHUNK].reshape(-1),
                    group=mesh.groups[axis])
            out = out.movedim(0, dim).contiguous()
        else:
            flat = x.detach().to(_via(mesh), copy=True).contiguous().view(-1)
            for piece in flat.split(_CHUNK):
                dist.all_reduce(piece, group=mesh.groups[axis])
            out = _block(flat.view(x.shape), axis, dim, mesh).to(x.device)
    LC.collective("reduce-scatter", out.numel() * out.element_size(), out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, partial_grad, mesh):
        ctx.axes, ctx.dim, ctx.partial, ctx.mesh = axes, dim, partial_grad, \
            mesh
        for a in reversed(axes):            # minor first: blocks in order
            x = _gather(x, a, dim, mesh)
        return x

    @staticmethod
    def backward(ctx, g):
        for a in ctx.axes:
            g = (_reduce_scatter(g, a, ctx.dim, ctx.mesh) if ctx.partial
                 else _block(g, a, ctx.dim, ctx.mesh))
        return g, None, None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        for a in axes:
            x = _reduce(x, a, mesh)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for a in ctx.axes:
            g = _reduce(g, a, ctx.mesh)
        return g, None, None


class _LocalBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, mesh):
        ctx.axes, ctx.dim, ctx.mesh = axes, dim, mesh
        for a in axes:                      # major first
            x = _block(x, a, dim, mesh)
        return x

    @staticmethod
    def backward(ctx, g):
        for a in reversed(ctx.axes):
            g = _gather(g, a, ctx.dim, ctx.mesh)
        return g, None, None, None


def all_gather(x: torch.Tensor, axes, dim: int,
               partial_grad: bool = True) -> torch.Tensor:
    """x's blocks on the ranks of ``axes`` (a name or a tuple, major to
    minor) concatenated along ``dim``.  The backward reduce-scatters the
    cotangent, as each rank's use of the whole is a part of the gradient
    (FSDP's gathered weight); with ``partial_grad=False`` it takes the
    rank's block, for a cotangent every rank holds whole (a gathered
    activation that the ranks then use alike).  The identity off a rank
    mesh."""
    axes = _mesh_axes(axes)
    return (_AllGather.apply(x, axes, dim, partial_grad, rank_mesh())
            if axes else x)


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of x over the ranks of ``axes``; the backward passes the
    cotangent on (each rank's part gets the whole).  The identity off a
    rank mesh."""
    axes = _mesh_axes(axes)
    return _Psum.apply(x, axes, rank_mesh()) if axes else x


def psum_grad(x: torch.Tensor, axes) -> torch.Tensor:
    """x; the backward sums the cotangent over the ranks of ``axes``: a
    tensor every rank holds whole and uses for its own part of the work
    (the input of a tensor-parallel region).  The identity off a rank
    mesh."""
    axes = _mesh_axes(axes)
    return _PsumGrad.apply(x, axes, rank_mesh()) if axes else x


def local_block(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of x (whole on every rank of
    ``axes``); the backward all-gathers the cotangent.  The identity off a
    rank mesh."""
    axes = _mesh_axes(axes)
    return _LocalBlock.apply(x, axes, dim, rank_mesh()) if axes else x


def reduce_plain(x: torch.Tensor, axes, op=None) -> torch.Tensor:
    """The sum (or ``op``, a ``dist.ReduceOp``) of x over the ranks of
    ``axes``, outside autograd: a gradient's or a metric's."""
    for a in _mesh_axes(axes):
        x = _reduce(x, a, rank_mesh(), op)
    return x


def gather_params(tree, specs):
    """FSDP's gather: each leaf of ``tree`` (this rank's blocks, laid out
    by the matching ``specs``) gathered over every axis but ``TP_AXIS``,
    so only the tensor-parallel split is left.  The backward
    reduce-scatters each gradient over those axes: the sum of every
    rank's part, this rank's block.  The identity off a rank mesh."""
    if rank_mesh() is None:
        return tree

    def one(t, spec):
        for d, entry in enumerate(spec):
            names = _names(entry)
            axes = tuple(a for a in names if a != TP_AXIS)
            if axes and TP_AXIS in names:
                raise NotImplementedError(
                    f"a dim split jointly over {names} (the tensor-parallel "
                    f"axis with another) does not run sharded")
            if axes:
                t = all_gather(t, axes, d)
        return t

    return tree_map(one, tree, specs)


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]],
              src: Optional[PartitionSpec] = None,
              partial: Sequence[str] = ()) -> torch.Tensor:
    """``x`` brought to the layout ``logical_axes`` give on the active
    mesh (the JAX package's ``with_sharding_constraint``).

    The identity outside a rules context and on a mesh of one device.  On
    a mesh of ranks ``x`` is this rank's block laid out by ``src`` (by
    default already the target's) and still to be summed over the axes
    ``partial`` (a row-parallel product's partial sum): the sum is taken
    (``psum``), then each dim that ``src`` splits and the target does not
    is gathered and each the target splits is sliced.  Gathered and sliced
    dims are activations the ranks go on to use alike, so the gather's
    backward takes the rank's block and the slice's gathers.  A mesh
    description (no rank's place on it; see ``launch.mesh.rank_view``)
    raises ``ValueError``."""
    if _ACTIVE is None or _ACTIVE.mesh.n_devices == 1:
        return x
    mesh = _ACTIVE.mesh
    if not mesh.ranked:
        raise ValueError(
            f"constrain: the {dict(mesh.shape)} mesh is a description; a "
            f"step runs on one rank's place on it (launch.mesh."
            f"make_rank_mesh, or rank_view on meta)")
    x = psum(x, tuple(partial))
    if src is None:
        return x
    src = PartitionSpec(*(tuple(src) + (None,) * (x.dim() - len(src))))
    target = logical_spec(logical_axes, global_shape(x.shape, src, mesh))
    for d, (have, want) in enumerate(zip(src, target)):
        if _names(have) != _names(want):
            x = all_gather(x, have, d, partial_grad=False)
            x = local_block(x, want, d)
    return x



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

"""The step's own cost counter, and each kernel's cost formula.

The JAX package's ``launch/loopcost.py`` corrects XLA: ``cost_analysis``
counts each while-loop body once, so it walks the step's jaxpr to restore
the scan trip counts (``jaxpr_costs``, ``loop_corrections``) and parses
the post-SPMD HLO for the collectives inside loops.  The port runs its
steps eagerly: every op that executes is one dispatch, counted once per
execution, and there is no HLO.  So this module counts for itself, and
``scan_once``, ``loop_corrections`` and the HLO parsers have no
counterpart: a loop's every trip is counted because every trip runs.

``step_costs(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode``
(``CostCounter``), on ``meta``, the CPU or the card alike, and counts:

* ``dot_flops``: 2 * batch * m * n * k for each matmul-family op (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``), as the JAX package's
  ``_dot_flops`` counts each ``dot_general``; plus each kernel call's own
  flops;
* ``io_bytes``: the input plus output bytes of every op that touches
  memory (views and bare allocations do not), the counterpart of
  ``jaxpr_costs``' per-equation bytes: in eager mode each op really does
  read its inputs from and write its outputs to device memory; plus each
  kernel call's own bytes;
* ``peak_bytes``: the most bytes held at once by the arguments and the
  outputs still referenced (each storage once, freed when its last tensor
  goes);
* ``collectives`` and ``collective_calls``: bytes and calls by kind that
  ``sharding.rules.FleetSharding``'s collectives report (none on one
  process);
* ``kernel_calls``: calls per kernel.

A kernel's call is counted by its own formula, never by the ops inside it:
each kernel entry point is wrapped by ``counted``, which pauses the
counters while the entry runs (the CUDA launch, which no dispatch mode
sees; on the CPU the plain version; on ``meta`` an empty output) and then
adds the formula (``agg_cost``, ``sgd_cost``, ``flash_cost``, ``ssd_cost``,
``router_cost``).  So one step counts the same integers on ``meta``, the
CPU and the card.  ``torch.utils.flop_counter.FlopCounterMode`` alone
cannot do this: it never sees a ``ctypes`` launch.

The formulas are also the kernels' bounds (``Cost.bound``): bytes as each
input read once and each output written once, flops over the peak rate of
the inputs' type (``launch.mesh``: the H100's data sheet).  Where the work
depends on the data (``aggregate``'s nonzero weight columns and distinct
ids, ``fused_sgd``'s active rows), ``data=True`` counts what host inputs
need; a kernel call inside a step counts every column and row, since
reading a device value would stall the step (and ``meta`` has none).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32

aten = torch.ops.aten


# --------------------------------------------------------------------------- #
# each kernel's cost
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Cost:
    """One kernel call's work: ``nbytes`` moved, ``flops`` done at the
    peak rate ``flops_per_s`` of its inputs' type."""
    nbytes: float
    flops: float
    flops_per_s: float = PEAK_FLOPS_F32

    def bound(self) -> Tuple[float, str]:
        """(ms, "bytes" | "operations"): the least time the card could
        take, the larger of bytes over the memory rate and flops over the
        peak rate, and which of the two it is."""
        t_bytes = self.nbytes / HBM_BW * 1e3
        t_ops = self.flops / self.flops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


def agg_cost(W: torch.Tensor, col_ids: Optional[torch.Tensor], p: int,
             n_rows: int, data: bool = True) -> Cost:
    """``aggregate``: Y (k, P) = W (k, n_in) @ X[col_ids] over an (N, P) f32
    buffer.  Bytes: the distinct buffer rows read, Y written, W and the ids
    read; flops: 2 per (output, nonzero W column, column of P).  ``data``
    counts W's nonzero columns and the distinct ids from their values
    (host tensors), else every column and id."""
    k, n_in = W.shape
    if data:
        distinct = n_rows if col_ids is None else len(set(col_ids.tolist()))
        nz_cols = int((W != 0).any(0).sum())
    else:
        distinct = n_rows if col_ids is None else n_in
        nz_cols = n_in
    nbytes = (distinct * p + k * p + W.numel()) * 4 \
        + (0 if col_ids is None else col_ids.numel() * 4)
    return Cost(nbytes, 2.0 * k * nz_cols * p)


def sgd_cost(spec, active: torch.Tensor, k: int, steps: int, batch: int,
             with_losses: bool, data: bool = True) -> Cost:
    """``fused_sgd``: ``steps`` SGD steps of the 3-layer MLP ``spec`` on
    the active rows of k (a forward for the loss on the others when
    ``with_losses``).  Bytes: the rows read and written, the mask and each
    needed row's minibatches; flops: the MLP's products.  ``data`` counts
    the active rows from ``active``'s values, else every row."""
    shp = dict(zip(spec.keys, spec.shapes))
    (d, h), (_, g), (_, c) = shp["w1"], shp["w2"], shp["w3"]
    n_act = int((active != 0).sum()) if data else k
    per_fwd = 2.0 * batch * (d * h + h * g + g * c)
    per_step = 2.0 * batch * (2 * d * h + 3 * h * g + 3 * g * c)
    flops = steps * (n_act * per_step
                     + (k - n_act) * (per_fwd if with_losses else 0.0))
    needs_batch = n_act if not with_losses else k
    nbytes = (2 * k * spec.n_params + 2 * k
              + needs_batch * steps * batch * (d + 1)) * 4
    return Cost(nbytes, flops)


def attention_pairs(s: int, causal: bool, window: Optional[int]) -> int:
    """Unmasked (query row, key column) pairs of an S x S attention mask:
    causal keeps columns <= the row, a window keeps rows - columns <
    window."""
    rows = np.arange(s, dtype=np.int64)
    hi = rows if causal else np.full(s, s - 1, dtype=np.int64)
    lo = 0 if window is None else np.maximum(0, rows - window + 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_cost(q: torch.Tensor, k: torch.Tensor, causal: bool,
               window: Optional[int]) -> Cost:
    """``flash_attention``: bytes are q, k, v (as passed, kv heads once)
    read and o written once; flops 4 D per unmasked (row, column) pair,
    over the peak rate for the inputs' type."""
    b, h, s, d = q.shape
    pairs = attention_pairs(s, causal, window)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    rate = PEAK_FLOPS_BF16 if q.dtype == torch.bfloat16 else PEAK_FLOPS_F32
    return Cost(nbytes, 4.0 * d * pairs * b * h, rate)


def ssd_cost(g: int, h: int, q: int, n: int, p: int) -> Cost:
    """``ssd_chunk``: bytes are Bc, Cc, cum_la and xbar read once and y
    written once (f32); flops, for each causal (q, t) pair of each chunk,
    2 N for the score and H * 2 P for the products, at the f32 rate."""
    pairs = q * (q + 1) // 2
    nbytes = 4 * (2 * g * q * n + g * h * q + 2 * g * h * q * p)
    return Cost(nbytes, float(g) * pairs * (2 * n + 2 * h * p))


def router_cost(t: int, e: int, k: int) -> Cost:
    """``moe_router``: the f32 logits read once, gates (f32) and ids (i32)
    written once; its compares are far below any unit's rate."""
    return Cost(4.0 * t * e + 8.0 * t * k, 0.0)


# --------------------------------------------------------------------------- #
# the counter
# --------------------------------------------------------------------------- #


def _mm(a, b, *_):
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b, *_):
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


_DOT_FLOPS: Dict[object, Callable] = {
    aten.mm.default: _mm,
    aten.addmm.default: lambda bias, a, b, *_: _mm(a, b),
    aten.bmm.default: _bmm,
    aten.baddbmm.default: lambda inp, a, b, *_: _bmm(a, b),
    aten.mv.default: lambda a, v, *_: 2 * a.shape[0] * a.shape[1],
    aten.dot.default: lambda a, b, *_: 2 * a.shape[0],
}
# ops that move no bytes: bare allocations, and views their schema does
# not mark as such
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_like.default,
               aten.empty_strided.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten._unsafe_view.default,
               aten.lift_fresh.default}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


_ACTIVE: List["CostCounter"] = []


class CostCounter(TorchDispatchMode):
    """Counts the ops that run under it (see the module docstring).  Use
    ``step_costs``, or ``with CostCounter() as c:`` and read ``c``."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0
        self.io_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.arg_bytes = 0
        self.collectives: Dict[str, int] = collections.Counter()
        self.collective_calls: Dict[str, int] = collections.Counter()
        self.kernel_calls: Dict[str, int] = collections.Counter()
        self._paused = 0
        self._live: set = set()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @property
    def activation_peak_bytes(self) -> int:
        """The peak above the arguments: what the step itself held."""
        return self.peak_bytes - self.arg_bytes

    def track(self, tensors) -> None:
        """Count each new storage of ``tensors`` live until it is freed."""
        for t in _tensors(tensors):
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live.add(key)
            self.live_bytes += n
            weakref.finalize(st, self._free, key, n).atexit = False
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int, n: int) -> None:
        self._live.discard(key)
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        dot = _DOT_FLOPS.get(func)
        if dot is not None:
            self.dot_flops += dot(*args)
        if not (func.is_view or func in _NO_TRAFFIC):
            self.io_bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        if not (func.is_view or func._schema.is_mutable):
            self.track(out)
        return out


@contextlib.contextmanager
def _paused():
    for c in _ACTIVE:
        c._paused += 1
    try:
        yield
    finally:
        for c in _ACTIVE:
            c._paused -= 1


def counted(name: str, cost: Callable[..., Cost]) -> Callable:
    """Decorate a kernel entry point: under an active counter its call is
    counted as ``cost(*args, **kwargs)`` (flops, bytes, one call of
    ``name``) and its outputs as new storages, never by the ops it runs.
    Without a counter it is the entry point itself."""
    def wrap(entry: Callable) -> Callable:
        @functools.wraps(entry)
        def run(*args, **kwargs):
            if not _ACTIVE:
                return entry(*args, **kwargs)
            with _paused():
                out = entry(*args, **kwargs)
            c = cost(*args, **kwargs)
            for counter in _ACTIVE:
                counter.dot_flops += int(c.flops)
                counter.io_bytes += int(c.nbytes)
                counter.kernel_calls[name] += 1
                counter.track(out)
            return out
        return run
    return wrap


def collective(kind: str, nbytes: int) -> None:
    """Report ``nbytes`` of a ``kind`` collective to the active counters
    (``sharding.rules.FleetSharding`` calls it)."""
    for c in _ACTIVE:
        c.collectives[kind] += int(nbytes)
        c.collective_calls[kind] += 1


def step_costs(fn: Callable, *args) -> CostCounter:
    """Run ``fn(*args)`` once under a fresh ``CostCounter`` and return the
    counter: ``dot_flops`` and ``io_bytes`` (the JAX package's
    ``jaxpr_costs(..., scan_once=False)`` pair), ``peak_bytes`` over the
    arguments (``arg_bytes``) and the outputs still referenced,
    ``collectives`` and ``kernel_calls``.  ``fn``'s result is dropped."""
    with CostCounter() as counter:
        counter.track(args)
        counter.arg_bytes = counter.live_bytes
        fn(*args)
    return counter

"""Eq. 4 model mix: ``Y = W @ X[col_ids]`` — CUDA kernel and plain version.

The port of ``repro.kernels.aggregate`` (``aggregate_rows`` and
``aggregate_rows_cols``, both on the TPU panel kernel ``_panel_matmul``): one
wrapper, ``aggregate``, covers the row-sparse mix (``col_ids=None``: the k
gathered non-identity rows of W against all N buffer rows) and the
column-sparse mix (W restricted to the u-column union, ``col_ids`` naming
those buffer rows; padding entries may repeat an index with their W column
zeroed).  On a CUDA tensor it launches ``csrc/aggregate.cu``, which fuses the
column gather into its loads; on a CPU tensor it runs ``aggregate_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.launch import loopcost as LC

_SIGNATURES = {
    "repro_aggregate_f32": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]),
}


launches = 0      # CUDA launches of this kernel; callers zero it to count a run
launches_rows_sharded = 0    # ... of those made by aggregate_rows_sharded
launches_cols_sharded = 0    # ... of those made by aggregate_rows_cols_sharded

_INT_MAX = 2 ** 31 - 1
_GRID_X_MAX = 2 ** 31 - 1
_GRID_Y_MAX = 65535
_ROWS_PER_BLOCK = 8              # output rows per CUDA block, at most

def aggregate_plain(W: torch.Tensor, X: torch.Tensor,
                    col_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: ``W.float() @ X.float()[col_ids]``
    (``repro.kernels.ref.aggregate_rows_cols_ref``; ``aggregate_ref`` when
    ``col_ids`` is None)."""
    Xf = X.float()
    return W.float() @ (Xf if col_ids is None else Xf[col_ids.long()])


def _check(W, X, col_ids) -> None:
    if W.dim() != 2 or X.dim() != 2:
        raise ValueError(f"aggregate: W and X must be 2-D, got "
                         f"{tuple(W.shape)} and {tuple(X.shape)}")
    k, n_in = W.shape
    if k == 0:
        raise ValueError("aggregate: W has no rows (k = 0) — callers skip "
                         "the mix when no row changes")
    if col_ids is None:
        if n_in != X.shape[0]:
            raise ValueError(f"aggregate: W {tuple(W.shape)} does not "
                             f"contract with X {tuple(X.shape)}")
    elif tuple(col_ids.shape) != (n_in,):
        raise ValueError(f"aggregate: col_ids must be ({n_in},) to match W "
                         f"{tuple(W.shape)}, got {tuple(col_ids.shape)}")
    for name, t in (("W", W), ("X", X), ("col_ids", col_ids)):
        if t is not None and t.device != X.device:
            raise ValueError(f"aggregate: {name} is on {t.device}, X on "
                             f"{X.device}")


def check_sizes(k: int, n_in: int, n_rows: int, p: int, p_blk: int) -> None:
    """Raise unless the CUDA kernel takes this call.  k, n_in and N are C
    ints; P and every column offset are 64-bit, so only the grid bounds P:
    at most 2^31 - 1 blocks of ``p_blk`` columns on x (counted as if no load
    were wider than one float) and 65,535 blocks of 8 rows on y."""
    for name, v in (("k", k), ("n_in", n_in), ("N", n_rows)):
        if not 0 < v <= _INT_MAX:
            raise ValueError(f"aggregate: {name}={v} is outside the kernel's "
                             f"C int sizes")
    if p <= 0:
        raise ValueError(f"aggregate: P={p} parameter columns")
    if -(-p // p_blk) > _GRID_X_MAX:
        raise ValueError(f"aggregate: P={p} columns need more than "
                         f"{_GRID_X_MAX} blocks of {p_blk} columns")
    if -(-k // _ROWS_PER_BLOCK) > _GRID_Y_MAX:
        raise ValueError(f"aggregate: k={k} rows need more than "
                         f"{_GRID_Y_MAX} row blocks")


@LC.counted("aggregate", lambda W, X, col_ids=None, **_: LC.agg_cost(
    W, col_ids, X.shape[1], X.shape[0], data=False))
def aggregate(W: torch.Tensor, X: torch.Tensor,
              col_ids: Optional[torch.Tensor] = None, *,
              p_blk: int = 128) -> torch.Tensor:
    """``Y (k, P) = W (k, n_in) @ X[col_ids] (n_in, P)`` in f32.

    ``col_ids`` (n_in,) int32, or None for ``n_in == N`` and the identity
    gather.  CPU tensors run ``aggregate_plain``; ``meta`` tensors give an
    empty output.  CUDA tensors launch the kernel with ``p_blk`` threads
    per block (``KernelConfig.agg_p_blk``) and need contiguous f32
    ``W``/``X`` and contiguous int32 ``col_ids``; an index outside ``[0,
    N)`` turns the outputs NaN.  Counts its kernel launches in the
    module's ``launches``; an active ``launch.loopcost`` counter counts the
    call by ``agg_cost`` (every column)."""
    _check(W, X, col_ids)
    if X.device.type == "meta":
        return X.new_empty((W.shape[0], X.shape[1]), dtype=torch.float32)
    if X.device.type == "cpu":
        return aggregate_plain(W, X, col_ids)
    if X.device.type != "cuda":
        raise ValueError(f"aggregate: no kernel for device {X.device}")
    for name, t, dtype in (("W", W, torch.float32), ("X", X, torch.float32),
                           ("col_ids", col_ids, torch.int32)):
        if t is not None and (t.dtype != dtype or not t.is_contiguous()):
            raise ValueError(f"aggregate: the CUDA kernel needs a contiguous "
                             f"{dtype} {name}, got {t.dtype} "
                             f"(contiguous={t.is_contiguous()})")
    k, n_in = W.shape
    n_rows, p = X.shape
    check_sizes(k, n_in, n_rows, p, p_blk)
    Y = torch.empty((k, p), dtype=torch.float32, device=X.device)
    lib = _build.load("aggregate", _SIGNATURES)
    with torch.cuda.device(X.device):
        err = lib.repro_aggregate_f32(
            W.data_ptr(), X.data_ptr(),
            None if col_ids is None else col_ids.data_ptr(), Y.data_ptr(),
            k, n_in, n_rows, p, p_blk,
            torch.cuda.current_stream(X.device).cuda_stream)
    if err:
        raise RuntimeError(f"aggregate kernel launch failed: CUDA error "
                           f"{err} (k={k}, n_in={n_in}, P={p}, "
                           f"p_blk={p_blk})")
    global launches
    launches += 1
    return Y



# --------------------------------------------------------------------------- #
# the mesh twins: the same kernel on each rank's block, plus one all-reduce
# --------------------------------------------------------------------------- #
#
# The ports of ``repro.kernels.aggregate.aggregate_rows_sharded_kernel`` and
# ``aggregate_rows_cols_sharded_kernel`` (each a ``shard_map`` around
# ``_panel_matmul``).  ``X`` is this rank's ``(block, P)`` block of the
# row-partitioned buffer (``sharding.rules.FleetSharding``); ``seg`` is the
# rank's ``[lo, hi)`` segment of the k gathered output rows
# (``FleetSharding.for_rows``): the rows of its own block, which it scatters
# back locally.  The reference splits the k output rows evenly over the
# shards when S divides k; computing each rank's home segment instead keeps
# every scatter local and needs no all-gather (gloo has none for CUDA
# tensors), with the same value for every row.  Each twin's plain version is
# ``aggregate_plain`` on the whole buffer.


def aggregate_rows_sharded(W_rows: torch.Tensor, X: torch.Tensor, shd,
                           seg, *, p_blk: int = 128) -> torch.Tensor:
    """Row-sparse Eq. 4 over a row-partitioned buffer: the rows ``[lo, hi)``
    of ``W_rows @ X_full``.

    ``W_rows`` (k, N_pad) holds the gathered rows of W with the padding
    columns zero (``worker.pad_w_cols``).  The contraction axis is the
    sharded axis: each rank multiplies its ``(k, block)`` column block of W
    with its block by ``aggregate`` (one launch, on a contiguous copy of
    k * block floats), and one all-reduce of the (k, P) partial products
    completes every row on every rank."""
    lo, hi = shd.home
    Y = aggregate(W_rows[:, lo:hi].contiguous(), X, p_blk=p_blk)
    if X.device.type == "cuda":
        global launches_rows_sharded
        launches_rows_sharded += 1
    shd.psum(Y)
    return Y[seg[0]:seg[1]]


def aggregate_rows_cols_sharded(W_sub: torch.Tensor, col_ids: torch.Tensor,
                                X: torch.Tensor, shd, seg, *,
                                p_blk: int = 128) -> torch.Tensor:
    """Column-sparse Eq. 4 over a row-partitioned buffer: the rows
    ``[lo, hi)`` of ``W_sub @ X_full[col_ids]``.

    Each rank gathers the union rows that live in its block (``col_ids``
    shifted to local ids, the others zero), one all-reduce assembles the
    (u, P) slab from exactly u rows (each row is nonzero on one rank only,
    so the slab is exact), and the rank contracts its ``seg`` rows of
    ``W_sub`` with the slab by ``aggregate`` — one launch, none when the
    segment is empty."""
    block = X.shape[0]
    local = col_ids.long() - shd.home[0]
    inb = (local >= 0) & (local < block)
    slab = torch.where(inb[:, None],
                       X.index_select(0, local.clamp(0, block - 1)), 0.0)
    shd.psum(slab)
    lo, hi = seg
    if hi == lo:
        return slab.new_empty((0, slab.shape[1]))
    Y = aggregate(W_sub[lo:hi], slab, p_blk=p_blk)
    if X.device.type == "cuda":
        global launches_cols_sharded
        launches_cols_sharded += 1
    return Y

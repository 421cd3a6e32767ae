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

_SIGNATURES = {
    "repro_aggregate_f32": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
}


launches = 0      # CUDA launches of this kernel; callers zero it to count a run

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


def aggregate(W: torch.Tensor, X: torch.Tensor,
              col_ids: Optional[torch.Tensor] = None, *,
              p_blk: int = 128) -> torch.Tensor:
    """``Y (k, P) = W (k, n_in) @ X[col_ids] (n_in, P)`` in f32.

    ``col_ids`` (n_in,) int32, or None for ``n_in == N`` and the identity
    gather.  CPU tensors run ``aggregate_plain``.  CUDA tensors launch the
    kernel with ``p_blk`` columns per block (``KernelConfig.agg_p_blk``) and
    need contiguous f32 ``W``/``X`` and contiguous int32 ``col_ids``; an
    index outside ``[0, N)`` turns the affected outputs NaN.  Counts its
    kernel launches in the module's ``launches``."""
    _check(W, X, col_ids)
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


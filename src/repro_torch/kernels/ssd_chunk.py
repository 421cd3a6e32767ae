"""Mamba-2 SSD intra-chunk dual form — CUDA kernel and plain version.

The port of ``repro.kernels.ssd_chunk.ssd_chunk``::

    y[g, h, q] = sum_{t <= q} (C[g, q] . B[g, t])
                 * exp(la[g, h, q] - la[g, h, t]) * xbar[g, h, t]

over Bc, Cc (G, Q, N) shared by the heads, cum_la (G, H, Q) and xbar
(G, H, Q, P), all f32, to y (G, H, Q, P) f32.  On a CUDA tensor
``ssd_chunk`` launches ``csrc/ssd_chunk.cu``; on a CPU tensor it runs
``ref.ssd_chunk_plain``.  Unlike the TPU kernel's wrapper it needs no
transposes: every input takes (g, h, q) strides with a unit last dimension,
so the model's (B, nc, Q, H, P) views go in as they are, and y comes back
laid out like xbar.  The call launches two kernels: the causal tiles of the
head-shared score C B^T into a (G, Qp, Qp) scratch this wrapper allocates
(Qp = Q rounded up to 64), then one block per (64 query rows, head, g).
Below the diagonal tile the kernel splits the decay at the tile's first
row where ``cum_la`` falls along the chunk, as the model's cumulative log
decays do, and takes each pair's exponent directly otherwise, so it takes
any ``cum_la``, as the plain version does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunk_plain
from repro_torch.launch import loopcost as LC

__all__ = ["ssd_chunk", "ssd_chunk_plain", "launches"]

_SIGNATURES = {"repro_ssd_chunk_f32": (
    ctypes.c_int, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_longlong] * 13 + [ctypes.c_void_p])}
HEAD_DIMS = (16, 32, 64, 128)    # P: the kernel's template instances
MAX_CHUNK = 512                  # Q: csrc kMaxQ (a block's key factors)
Q_TILE = 64                      # csrc kBQ: query rows per block
_GRID_Z_MAX = 65535
_INT_MAX = 2 ** 31 - 1

launches = 0      # CUDA launches of this kernel; callers zero it to count a run


def _check(Bc, Cc, cum_la, xbar) -> None:
    if Bc.dim() != 3 or Cc.shape != Bc.shape:
        raise ValueError(f"ssd_chunk: Bc and Cc must both be (G, Q, N), got "
                         f"{tuple(Bc.shape)} and {tuple(Cc.shape)}")
    g, q, _ = Bc.shape
    if xbar.dim() != 4 or xbar.shape[0] != g or xbar.shape[2] != q:
        raise ValueError(f"ssd_chunk: xbar {tuple(xbar.shape)} must be "
                         f"(G, H, Q, P) for Bc {tuple(Bc.shape)}")
    if tuple(cum_la.shape) != tuple(xbar.shape[:3]):
        raise ValueError(f"ssd_chunk: cum_la {tuple(cum_la.shape)} must be "
                         f"(G, H, Q) = {tuple(xbar.shape[:3])}")
    if not (Bc.device == Cc.device == cum_la.device == xbar.device):
        raise ValueError("ssd_chunk: Bc, Cc, cum_la, xbar devices differ")


def check_sizes(g: int, h: int, q: int, n: int, p: int) -> None:
    """Raise unless the kernels' launches take (G, H, Q, N, P): P one of
    ``HEAD_DIMS``, Q at most ``MAX_CHUNK``, G within the score kernel's
    grid z, one block per (query tile, head, g) within a 1-D grid, N and
    H inside a C int."""
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd_chunk: the CUDA kernel takes head_dim P in "
                         f"{HEAD_DIMS}, got {p}")
    if not 0 < q <= MAX_CHUNK:
        raise ValueError(f"ssd_chunk: chunk Q={q} must be in [1, "
                         f"{MAX_CHUNK}]")
    if not 0 < g <= _GRID_Z_MAX:
        raise ValueError(f"ssd_chunk: G={g} must be in [1, {_GRID_Z_MAX}] "
                         f"(the score kernel's grid z)")
    if not 0 < h <= _INT_MAX or -(-q // Q_TILE) * g * h > _INT_MAX:
        raise ValueError(f"ssd_chunk: G={g}, H={h} and Q={q} need more than "
                         f"{_INT_MAX} blocks (one per query tile, head and g)")
    if not 0 < n <= _INT_MAX:
        raise ValueError(f"ssd_chunk: N={n} is outside a C int")


@LC.counted("ssd_chunk", lambda Bc, Cc, cum_la, xbar: LC.ssd_cost(
    *xbar.shape[:3], Bc.shape[2], xbar.shape[3]))
def ssd_chunk(Bc: torch.Tensor, Cc: torch.Tensor, cum_la: torch.Tensor,
              xbar: torch.Tensor) -> torch.Tensor:
    """(G, H, Q, P) f32 intra-chunk output, laid out like ``xbar``.

    CPU tensors run ``ssd_chunk_plain``; ``meta`` tensors give an empty
    output.  CUDA tensors launch the kernel: f32, P in ``HEAD_DIMS``, Q <=
    ``MAX_CHUNK``, last dimension contiguous.  Counts its launches in the
    module's ``launches``; an active ``launch.loopcost`` counter counts
    the call by ``ssd_cost``."""
    _check(Bc, Cc, cum_la, xbar)
    if xbar.device.type == "meta":
        return torch.empty_like(xbar, dtype=torch.float32)
    if xbar.device.type == "cpu":    # laid out like xbar, as the kernel's
        return torch.empty_like(xbar, dtype=torch.float32).copy_(
            ssd_chunk_plain(Bc, Cc, cum_la, xbar))
    if xbar.device.type != "cuda":
        raise ValueError(f"ssd_chunk: no kernel for device {xbar.device}")
    for name, t in (("Bc", Bc), ("Cc", Cc), ("cum_la", cum_la),
                    ("xbar", xbar)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_chunk: the CUDA kernel takes f32, got "
                             f"{name} {t.dtype}")
    for name, t in (("Bc", Bc), ("Cc", Cc), ("xbar", xbar)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_chunk: {name} needs a contiguous last "
                             f"dimension, got strides {t.stride()}")
    g, h, q, p = xbar.shape
    n = Bc.shape[2]
    check_sizes(g, h, q, n, p)
    y = torch.empty_like(xbar)         # xbar's strides where it is dense
    qp = -(-q // Q_TILE) * Q_TILE
    scores = torch.empty((g, qp, qp), dtype=torch.float32,
                         device=xbar.device)
    strides = (*Bc.stride()[:2], *Cc.stride()[:2], *cum_la.stride(),
               *xbar.stride()[:3], *y.stride()[:3])
    lib = _build.load("ssd_chunk", _SIGNATURES)
    with torch.cuda.device(xbar.device):
        err = lib.repro_ssd_chunk_f32(
            Bc.data_ptr(), Cc.data_ptr(), cum_la.data_ptr(), xbar.data_ptr(),
            y.data_ptr(), scores.data_ptr(), g, h, q, n, p, *strides,
            torch.cuda.current_stream(xbar.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error {err} "
                           f"(G={g}, H={h}, Q={q}, N={n}, P={p})")
    global launches
    launches += 1
    return y

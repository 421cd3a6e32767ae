"""Fused MoE router (softmax -> top-k -> renormalise) — CUDA kernel and
plain version.

The port of ``repro.kernels.moe_router.moe_router``: f32 logits (T, E) ->
gates (T, k) f32, renormalised to sum 1 (``max(sum, 1e-9)``), and expert ids
(T, k) int32, the k largest probabilities in descending order with the
lowest index winning a tie.  On a CUDA tensor ``moe_router`` launches
``csrc/moe_router.cu`` (a warp per token row, or a segment of 8 or 16 lanes
per row for E <= 16; the row in registers, shuffle max and sum, each lane's
candidates sorted once, then one arg-max over the lanes' heads per round);
on a CPU tensor it runs ``ref.moe_router_plain``.  The kernel's bound is the
launch itself at the decode shape: a row moves 4 E + 8 k bytes (384 bytes a
call at the grok-1 decode shape T = 8, E = 8, k = 2).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import moe_router_plain
from repro_torch.launch import loopcost as LC

__all__ = ["moe_router", "moe_router_plain", "check_sizes", "launches"]

_SIGNATURES = {"repro_moe_router_f32": (
    ctypes.c_int, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_longlong, ctypes.c_void_p])}
MAX_EXPERTS = 512                # csrc: 16 logits per lane of one warp
MAX_TOP_K = 16                   # csrc kMaxTopK
_INT_MAX = 2 ** 31 - 1

launches = 0      # CUDA launches of this kernel; callers zero it to count a run


def check_sizes(t: int, e: int, k: int) -> None:
    """Raise unless the kernel's launch takes (T, E, k): E in [1,
    ``MAX_EXPERTS``], k in [1, min(E, ``MAX_TOP_K``)], T in [1, INT_MAX]."""
    if not 0 < e <= MAX_EXPERTS:
        raise ValueError(f"moe_router: the CUDA kernel takes 1 to "
                         f"{MAX_EXPERTS} experts (one warp holds the row), "
                         f"got E={e}")
    if not 0 < k <= min(e, MAX_TOP_K):
        raise ValueError(f"moe_router: top_k={k} must be in [1, "
                         f"min(E={e}, {MAX_TOP_K})]")
    if not 0 < t <= _INT_MAX:
        raise ValueError(f"moe_router: T={t} tokens must be in [1, "
                         f"{_INT_MAX}]")


@LC.counted("moe_router", lambda logits, top_k: LC.router_cost(
    *logits.shape, top_k))
def moe_router(logits: torch.Tensor, top_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (T, k) f32, ids (T, k) int32) of f32 logits (T, E).

    CPU tensors run ``moe_router_plain``; ``meta`` tensors give empty
    outputs.  CUDA tensors launch the kernel: f32 logits with a unit
    expert stride, sizes as ``check_sizes`` takes.  Counts its launches in
    the module's ``launches``; an active ``launch.loopcost`` counter counts
    the call by ``router_cost``."""
    if logits.dim() != 2:
        raise ValueError(f"moe_router: logits must be (T, E), got "
                         f"{tuple(logits.shape)}")
    if logits.device.type == "meta":
        t = logits.shape[0]
        return (logits.new_empty((t, top_k), dtype=torch.float32),
                logits.new_empty((t, top_k), dtype=torch.int32))
    if logits.device.type == "cpu":
        return moe_router_plain(logits, top_k)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_router: no kernel for device {logits.device}")
    if logits.dtype != torch.float32:
        raise ValueError(f"moe_router: the CUDA kernel takes f32 logits, got "
                         f"{logits.dtype}")
    t, e = logits.shape
    check_sizes(t, e, top_k)
    if logits.stride(1) != 1:
        logits = logits.contiguous()
    gates = torch.empty((t, top_k), dtype=torch.float32, device=logits.device)
    ids = torch.empty((t, top_k), dtype=torch.int32, device=logits.device)
    lib = _build.load("moe_router", _SIGNATURES)
    with torch.cuda.device(logits.device):
        err = lib.repro_moe_router_f32(
            logits.data_ptr(), gates.data_ptr(), ids.data_ptr(), t, e, top_k,
            logits.stride(0),
            torch.cuda.current_stream(logits.device).cuda_stream)
    if err:
        raise RuntimeError(f"moe_router kernel launch failed: CUDA error "
                           f"{err} (T={t}, E={e}, k={top_k})")
    global launches
    launches += 1
    return gates, ids

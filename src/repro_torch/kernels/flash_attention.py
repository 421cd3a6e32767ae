"""Online-softmax (flash) attention forward — CUDA kernel and plain version.

The port of ``repro.kernels.flash_attention.flash_attention``: causal,
sliding-window and softcap masks over (B, H, S, D) queries, f32 scores and
accumulator, output in the input dtype.  On a CUDA tensor ``flash_attention``
launches ``csrc/flash_attention.cu``; on a CPU tensor it runs
``ref.flash_attention_plain``.  Unlike the TPU kernel it needs no padding
copy (the ragged S edge is masked in the kernel), reads GQA kv heads in
place (k/v with Hk heads, query head h reading kv head h // (H // Hk)), and
takes any strides with a unit last dimension, so the model's (B, S, H, D)
projections go in and out as transposed views without a copy.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain", "launches"]

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
         + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
_SIGNATURES = {"repro_flash_attention_f32": (ctypes.c_int, _ARGS),
               "repro_flash_attention_bf16": (ctypes.c_int, _ARGS)}
_SYMBOL = {torch.float32: "repro_flash_attention_f32",
           torch.bfloat16: "repro_flash_attention_bf16"}
HEAD_DIMS = (64, 128, 256)
_INT_MAX = 2 ** 31 - 1
_GRID_YZ_MAX = 65535
BLOCK_Q = 64                    # query rows per CUDA block (csrc kBQ)

launches = 0      # CUDA launches of this kernel; callers zero it to count a run


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be (B, H, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Hk, S, D) for q "
                         f"{tuple(q.shape)}")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"flash_attention: {h} query heads do not group "
                         f"over {k.shape[1]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: q, k, v dtypes differ "
                         f"({q.dtype}, {k.dtype}, {v.dtype})")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q, k, v devices differ")


def check_sizes(b: int, h: int, s: int, d: int) -> None:
    """Raise unless the kernel's launch takes (B, H, S, D): D one of
    ``HEAD_DIMS``, H and B within the grid's y and z limits, and every row
    index of S inside a C int."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if not (0 < h <= _GRID_YZ_MAX and 0 < b <= _GRID_YZ_MAX):
        raise ValueError(f"flash_attention: B={b} and H={h} must each be in "
                         f"[1, {_GRID_YZ_MAX}] (CUDA grid y/z)")
    if not 0 < s <= _INT_MAX - BLOCK_Q:
        raise ValueError(f"flash_attention: S={s} must be in [1, "
                         f"{_INT_MAX - BLOCK_Q}] (32-bit row indices)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """(B, H, S, D) attention output, laid out like ``q``.

    ``k``/``v``: (B, Hk, S, D) with H % Hk == 0.  CPU tensors run
    ``flash_attention_plain``.  CUDA tensors launch the kernel: f32 or bf16,
    D in ``HEAD_DIMS``, last dimension contiguous.  Counts its launches in
    the module's ``launches``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _SYMBOL:
        raise ValueError(f"flash_attention: the CUDA kernel takes f32 or "
                         f"bf16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"last dimension, got strides {t.stride()}")
    b, h, s, d = q.shape
    check_sizes(b, h, s, d)
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    if window is not None and not -_INT_MAX <= window <= _INT_MAX:
        raise ValueError(f"flash_attention: window {window} is outside a "
                         f"C int")
    o = torch.empty_like(q)
    strides = [x for t in (q, k, v, o) for x in t.stride()[:3]]
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = getattr(lib, _SYMBOL[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, k.shape[1], s, d, *strides,
            int(causal), int(window is not None),
            0 if window is None else int(window), int(softcap is not None),
            0.0 if softcap is None else float(softcap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)} {q.dtype}, "
                           f"kv heads {k.shape[1]})")
    global launches
    launches += 1
    return o

"""Online-softmax (flash) attention forward — CUDA kernels and plain version.

The port of ``repro.kernels.flash_attention.flash_attention``: causal,
sliding-window and softcap masks over (B, H, S, D) queries, f32 scores and
accumulator, output in the input dtype.  On a CUDA tensor ``flash_attention``
launches ``csrc/flash_attention.cu``; on a CPU tensor it runs
``ref.flash_attention_plain``.  Unlike the TPU kernel it needs no padding
copy (the ragged S edge is masked in the kernel), reads GQA kv heads in
place (k/v with Hk heads, query head h reading kv head h // (H // Hk)), and
takes strided views with a unit last dimension, so the model's (B, S, H, D)
projections go in and out as transposed views without a copy.

Two kernels.  bf16, the LM path's, runs both products on the tensor cores
(``wgmma``) over k/v tiles that TMA streams into shared memory: any D that is
a multiple of 8 up to 256, any B and H (a 1-D grid), and every base address
and (b, h, s) stride 16-byte aligned, as TMA needs (``check_alignment``; the
model's views always are).  f32 runs every product as IEEE ``fmaf`` on the
CUDA cores: D in ``F32_HEAD_DIMS``, B and H up to the grid's 65,535.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_plain
from repro_torch.launch import loopcost as LC

__all__ = ["flash_attention", "flash_attention_plain", "check_sizes",
           "check_alignment", "launches"]

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
         + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
_SIGNATURES = {"repro_flash_attention_f32": (ctypes.c_int, _ARGS),
               "repro_flash_attention_bf16": (ctypes.c_int, _ARGS)}
_SYMBOL = {torch.float32: "repro_flash_attention_f32",
           torch.bfloat16: "repro_flash_attention_bf16"}
F32_HEAD_DIMS = (64, 128, 256)  # the f32 kernel's template instances
BF16_MAX_HEAD_DIM = 256         # bf16: D % 8 == 0, padded to 64/128/256
TMA_ALIGN = 16                  # bytes: TMA's base and stride alignment
_INT_MAX = 2 ** 31 - 1
_GRID_YZ_MAX = 65535
BLOCK_Q = 64                    # query rows per warpgroup / f32 block

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


def check_sizes(b: int, h: int, s: int, d: int, dtype: torch.dtype) -> None:
    """Raise unless the kernel for ``dtype`` takes (B, H, S, D).

    bf16: D a multiple of 8 up to ``BF16_MAX_HEAD_DIM``, and the 1-D grid of
    (S / 64 tiles) x H x B blocks within a C int.  f32: D one of
    ``F32_HEAD_DIMS``, and B and H within the grid's y and z limits.  Both:
    every row index of S inside a C int."""
    if dtype == torch.float32:
        if d not in F32_HEAD_DIMS:
            raise ValueError(f"flash_attention: the f32 CUDA kernel takes "
                             f"head_dim in {F32_HEAD_DIMS}, got {d}")
        if not (0 < h <= _GRID_YZ_MAX and 0 < b <= _GRID_YZ_MAX):
            raise ValueError(f"flash_attention: B={b} and H={h} must each be "
                             f"in [1, {_GRID_YZ_MAX}] for the f32 kernel "
                             f"(CUDA grid y/z)")
    elif dtype == torch.bfloat16:
        if not (0 < d <= BF16_MAX_HEAD_DIM and d % 8 == 0):
            raise ValueError(f"flash_attention: the bf16 CUDA kernel takes "
                             f"head_dim a multiple of 8 up to "
                             f"{BF16_MAX_HEAD_DIM}, got {d}")
        if not (b > 0 and h > 0):
            raise ValueError(f"flash_attention: B={b} and H={h} must be > 0")
        if -(-s // BLOCK_Q) * h * b > _INT_MAX:
            raise ValueError(f"flash_attention: {-(-s // BLOCK_Q)} query "
                             f"tiles x H={h} x B={b} blocks exceed the 1-D "
                             f"grid's {_INT_MAX} (32-bit grid)")
    else:
        raise ValueError(f"flash_attention: the CUDA kernel takes f32 or "
                         f"bf16, got {dtype}")
    if not 0 < s <= _INT_MAX - BLOCK_Q:
        raise ValueError(f"flash_attention: S={s} must be in [1, "
                         f"{_INT_MAX - BLOCK_Q}] (32-bit row indices)")


def check_alignment(name: str, data_ptr: int, shape, strides,
                    itemsize: int) -> None:
    """Raise unless TMA can read the (B, H, S, D) tensor: its base address
    and the byte stride of every (b, h, s) dimension longer than 1 a
    multiple of ``TMA_ALIGN``, and a unit stride along D."""
    if strides[-1] != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous last "
                         f"dimension, got strides {tuple(strides)}")
    if data_ptr % TMA_ALIGN:
        raise ValueError(f"flash_attention: {name}'s base address "
                         f"{data_ptr:#x} is not {TMA_ALIGN}-byte aligned "
                         f"(TMA)")
    for n, st in zip(shape[:3], strides[:3]):
        if n > 1 and (st * itemsize) % TMA_ALIGN:
            raise ValueError(f"flash_attention: {name}'s strides "
                             f"{tuple(strides)} are not all multiples of "
                             f"{TMA_ALIGN} bytes (TMA)")


@LC.counted("flash_attention",
            lambda q, k, v, causal=True, window=None, softcap=None:
            LC.flash_cost(q, k, causal, window))
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """(B, H, S, D) attention output, laid out like ``q``.

    ``k``/``v``: (B, Hk, S, D) with H % Hk == 0.  CPU tensors run
    ``flash_attention_plain``; ``meta`` tensors give an empty output.
    CUDA tensors launch the kernel for their dtype (f32 or bf16) at the
    sizes ``check_sizes`` takes, last dimension contiguous, and bf16
    aligned as ``check_alignment`` says; anything else raises.  Counts its
    launches in the module's ``launches``; an active
    ``launch.loopcost`` counter counts the call by ``flash_cost``."""
    _check(q, k, v)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":       # laid out like q, as the kernel's
        return torch.empty_like(q).copy_(
            flash_attention_plain(q, k, v, causal, window, softcap))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _SYMBOL:
        raise ValueError(f"flash_attention: the CUDA kernel takes f32 or "
                         f"bf16, got {q.dtype}")
    b, h, s, d = q.shape
    check_sizes(b, h, s, d, q.dtype)
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    if window is not None and not -_INT_MAX <= window <= _INT_MAX:
        raise ValueError(f"flash_attention: window {window} is outside a "
                         f"C int")
    o = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if q.dtype == torch.bfloat16:
            check_alignment(name, t.data_ptr(), t.shape, t.stride(),
                            t.element_size())
        elif t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"last dimension, got strides {t.stride()}")
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

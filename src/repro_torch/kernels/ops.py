"""Differentiable model-plane entry points of the zoo kernels.

The port of the ``*_diff`` wrappers of ``repro.kernels.ops``.  There each is
a ``jax.custom_vjp`` whose forward is the Pallas kernel and whose backward
is ``jax.vjp`` of the matching ``kernels.ref`` oracle: the kernels ship
forward only.  Here each is a ``torch.autograd.Function`` built the same
way, by design: the forward is the CUDA kernel (on a CPU tensor, its plain
version), and the backward recomputes the plain version under
``torch.enable_grad()`` and takes its gradient.  So on the card the plain
code runs in the backward pass only, never in the forward.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_router as _mr
from repro_torch.kernels import ssd_chunk as _sc
from repro_torch.kernels.ref import (flash_attention_plain, moe_router_plain,
                                     ssd_chunk_plain)


def rounded_sum(x: torch.Tensor, dims) -> torch.Tensor:
    """The sum over ``dims`` (an int or a tuple) as the JAX package's CPU
    backend reduces a bf16 (or f16) tensor: every add rounded to x's
    dtype, in windows of up to 32 along each summed dim (XLA's tree
    reduction), each window summed in row-major order, then the windows'
    sums reduced the same way until at most 32 remain along every dim,
    which are summed in row-major order (``tests/test_torch_blocks_grad
    .py`` pins the rule against XLA).  An f32 tensor is summed as
    ``torch.sum`` sums it (sum order only).  One vector op per element of
    a window: a reduction the reference runs in its activation dtype,
    never a hot loop."""
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    if x.dtype in (torch.float32, torch.float64):
        return x.sum(dims)
    k = len(dims)
    dims = sorted(d % x.dim() for d in dims)
    x = x.permute(dims + [d for d in range(x.dim()) if d not in dims])
    while True:
        lead, rest = tuple(x.shape[:k]), tuple(x.shape[k:])
        if all(n <= 32 for n in lead):
            terms = x.reshape((-1,) + rest)
            break
        wins = [min(n, 32) for n in lead]
        pads = [(-n) % w for n, w in zip(lead, wins)]
        if any(pads):       # adding zeros changes no rounded partial sum
            pad = [0, 0] * len(rest)
            for q in reversed(pads):
                pad += [0, q]
            x = torch.nn.functional.pad(x, pad)
        split = []
        for n, p_, w in zip(lead, pads, wins):
            split += [(n + p_) // w, w]
        x = x.reshape(tuple(split) + rest)
        order = ([2 * i for i in range(k)] + [2 * i + 1 for i in range(k)]
                 + [2 * k + i for i in range(len(rest))])
        x = x.permute(order)
        outer = tuple(x.shape[:k])
        x = x.reshape(outer + (-1,) + rest)
        acc = x[(slice(None),) * k + (0,)]
        for i in range(1, x.shape[k]):
            acc = acc + x[(slice(None),) * k + (i,)]
        x = acc
    out = terms[0]
    for i in range(1, terms.shape[0]):
        out = out + terms[i]
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, softcap, q_offset)
        return _fa.flash_attention(q, k, v, causal, window, softcap,
                                   q_offset)

    @staticmethod
    def backward(ctx, g):
        """The plain version's gradient on keys and values repeated to H
        heads, as the reference's model repeats them before its kernel,
        then each kv head's G copies summed as the reference's transpose
        of that repeat sums them (``rounded_sum``)."""
        q, k, v = ctx.saved_tensors
        b, hk, s, d = k.shape
        grp = q.shape[1] // hk
        q = q.detach().requires_grad_()
        k = k.detach().repeat_interleave(grp, dim=1).requires_grad_()
        v = v.detach().repeat_interleave(grp, dim=1).requires_grad_()
        with torch.enable_grad():
            out = flash_attention_plain(q, k, v, *ctx.mask)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        if grp > 1:
            dk = rounded_sum(dk.reshape(b, hk, grp, s, d), 2)
            dv = rounded_sum(dv.reshape(b, hk, grp, s, d), 2)
        return dq, dk, dv, None, None, None, None


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Differentiable flash attention over (B, H, Sq, D) queries and
    (B, Hk, S, D) keys/values, query row r at row ``q_offset + r`` of the
    sequence (``kernels.flash_attention``)."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap, q_offset)


class _SSDChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Bc, Cc, cum_la, xbar):
        ctx.save_for_backward(Bc, Cc, cum_la, xbar)
        return _sc.ssd_chunk(Bc, Cc, cum_la, xbar)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ssd_chunk_plain(*ins)
        return torch.autograd.grad(out, ins, g)


def ssd_chunk_diff(Bc: torch.Tensor, Cc: torch.Tensor, cum_la: torch.Tensor,
                   xbar: torch.Tensor) -> torch.Tensor:
    """Differentiable intra-chunk SSD over (G, Q, N) B/C, (G, H, Q) log
    decays and (G, H, Q, P) inputs (``kernels.ssd_chunk``)."""
    return _SSDChunk.apply(Bc, Cc, cum_la, xbar)


class _MoERouter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, top_k):
        ctx.save_for_backward(logits)
        ctx.top_k = top_k
        gates, ids = _mr.moe_router(logits, top_k)
        ctx.mark_non_differentiable(ids)
        return gates, ids

    @staticmethod
    def backward(ctx, g_gates, _g_ids):
        (logits,) = ctx.saved_tensors
        logits = logits.detach().requires_grad_()
        with torch.enable_grad():
            gates, _ = moe_router_plain(logits, ctx.top_k)
        (g,) = torch.autograd.grad(gates, logits, g_gates)
        return g, None


def moe_router_diff(logits: torch.Tensor, top_k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable router over f32 logits (T, E) -> (gates (T, k) f32,
    ids (T, k) int32, no gradient) (``kernels.moe_router``).

    One launch gives both outputs.  The JAX package launches its kernel
    twice, the second time for the ids alone, to keep a float0 tangent out
    of the integer slot arithmetic; autograd has no such constraint, and
    the ids are simply marked non-differentiable."""
    return _MoERouter.apply(logits, top_k)

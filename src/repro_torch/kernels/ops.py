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


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, softcap)
        return _fa.flash_attention(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_plain(q, k, v, *ctx.mask)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention over (B, H, S, D) queries and
    (B, Hk, S, D) keys/values (``kernels.flash_attention``)."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap)


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

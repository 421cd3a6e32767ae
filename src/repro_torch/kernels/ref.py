"""Plain PyTorch versions of the zoo kernels (the port of
``repro.kernels.ref``): what a CPU tensor runs, what the CPU tests hold
against the Pallas kernels, what ``chip_smoke.py`` holds the CUDA kernels
against on the card, and what the autograd backward differentiates."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """Attention over (B, H, Sq, D) queries: ``repro.kernels.ref.
    flash_attention_ref`` in f32 (scores scaled by ``D ** -0.5``, softcap
    before the masks, masked scores -1e30), output in q's dtype.

    Three extensions, all matching the kernel: ``k``/``v`` may carry Hk
    heads with H % Hk == 0, query head h reading kv head ``h // (H // Hk)``
    (the model's GQA order); query row r is row ``q_offset + r`` of the
    (B, Hk, S, D) keys' sequence in the causal and window masks (a rank's
    block of rows under context parallelism; Sq == S and 0 for the whole
    sequence); and a row whose every column is masked (only a window <= 0
    does that) comes out 0, where the reference's softmax would average v
    uniformly."""
    b, h, s, d = q.shape
    if k.shape[1] != h:
        k = k.repeat_interleave(h // k.shape[1], dim=1)
        v = v.repeat_interleave(h // v.shape[1], dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    rows = q_offset + torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((s, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & ((rows - cols) < window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def ssd_chunk_plain(Bc: torch.Tensor, Cc: torch.Tensor, cum_la: torch.Tensor,
                    xbar: torch.Tensor) -> torch.Tensor:
    """The Mamba-2 intra-chunk SSD dual form, ``repro.kernels.ref.
    ssd_chunk_ref`` in f32::

        y[g, h, q] = sum_{t <= q} (C[g, q] . B[g, t])
                     * exp(la[g, h, q] - la[g, h, t]) * xbar[g, h, t]

    ``Bc``/``Cc`` (G, Q, N) are shared by the heads; ``cum_la`` (G, H, Q);
    ``xbar`` (G, H, Q, P); returns (G, H, Q, P) f32.

    The causal mask is applied before ``exp`` (``exp(where(causal, decay,
    -inf))``), where the reference takes ``where(causal, exp(decay), 0)``.
    The forward is the same.  The gradient differs only where the
    reference's is not finite: a masked exponent past f32's ``exp`` limit
    (~88, a long chunk at large ``dt``) overflows there to inf, and the
    reference's backward multiplies it by 0."""
    scores = Cc.float() @ Bc.float().transpose(-1, -2)            # (G, Q, Q)
    la = cum_la.float()
    q = scores.shape[-1]
    causal = torch.ones((q, q), dtype=torch.bool,
                        device=scores.device).tril()
    decay = la[..., :, None] - la[..., None, :]                 # (G, H, Q, Q)
    l_mat = torch.exp(torch.where(causal, decay, -torch.inf))
    return (scores[:, None] * l_mat) @ xbar.float()


def moe_router_plain(logits: torch.Tensor, top_k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused MoE router of ``repro.kernels.moe_router`` in f32, by the
    Pallas kernel's own rule: softmax over the E experts (max subtracted,
    ``exp``, divided by the sum), then ``top_k`` rounds that each take the
    row's largest remaining probability, the lowest index winning a tie,
    and mask it with -1.0; the chosen probabilities are renormalised by
    ``max(sum, 1e-9)``.  ``logits`` (T, E) -> (gates (T, k) f32, ids (T, k)
    int32).  Not ``torch.topk``: its tie order on CUDA is not specified."""
    x = logits.float()
    x = x - x.max(dim=-1, keepdim=True).values
    probs = torch.exp(x)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    cols = torch.arange(probs.shape[-1], device=probs.device)
    remaining = probs
    gates, ids = [], []
    for _ in range(top_k):
        g = remaining.max(dim=-1, keepdim=True).values
        a = torch.where(remaining == g, cols, probs.shape[-1]).min(
            dim=-1, keepdim=True).values
        gates.append(torch.gather(probs, -1, a))   # == g; its gradient
        ids.append(a)                              # goes to the chosen id
        remaining = torch.where(cols == a, -1.0, remaining)
    g = torch.cat(gates, dim=-1)
    g = g / torch.clamp(g.sum(dim=-1, keepdim=True), min=1e-9)
    return g, torch.cat(ids, dim=-1).to(torch.int32)

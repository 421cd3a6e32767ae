"""Plain PyTorch versions of the zoo kernels (the port of
``repro.kernels.ref``): what a CPU tensor runs, what the CPU tests hold
against the Pallas kernels, what ``chip_smoke.py`` holds the CUDA kernels
against on the card, and what the autograd backward differentiates."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, S, D) queries: ``repro.kernels.ref.
    flash_attention_ref`` in f32 (scores scaled by ``D ** -0.5``, softcap
    before the masks, masked scores -1e30), output in q's dtype.

    Two extensions, both matching the kernel: ``k``/``v`` may carry Hk heads
    with H % Hk == 0, query head h reading kv head ``h // (H // Hk)`` (the
    model's GQA order); and a row whose every column is masked (only a
    window <= 0 does that) comes out 0, where the reference's softmax would
    average v uniformly."""
    b, h, s, d = q.shape
    if k.shape[1] != h:
        k = k.repeat_interleave(h // k.shape[1], dim=1)
        v = v.repeat_interleave(h // v.shape[1], dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & ((rows - cols) < window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)

"""Mixture-of-Experts FFN with sort-based capacity dispatch (the port of
``repro.models.moe``).

Tokens are routed by the fused router (``kernels.moe_router``: the CUDA
kernel on the card, its plain version on the CPU) on f32 logits; positions
within each expert come from a stable argsort and a segment-offset search;
the expert products run over an (E, C, D) buffer, one batched product per
projection (outside any kernel, as in the JAX package, where XLA ran them).
Every expert's weights are read on every call, whatever the routing.

Capacity groups.  ``moe_ffn(..., per_row=True)`` dispatches each batch row
on its own, with the capacity of its own S tokens: the JAX serving engine
vmaps a one-row decode step, so each slot routes alone, and no slot's token
is dropped for another's.  The buffer is then (E, B * C, D), row b's slots
at ``e * B * C + b * C + position``; the expert products are the same.
``per_row=False`` (the default) is the JAX package's ``moe_ffn``: one group
of all B * S tokens.

Training: the gates carry the router's gradient (``kernels.ops.
moe_router_diff``: the kernel's forward, the plain version's backward), and
``route`` returns the Switch-style load-balance term, which the registry's
``compute_loss`` adds at ``router_aux_weight``.  Dropped choices land on a
dummy row that is discarded before the expert products, so they add
nothing to any gradient.  ``moe_axes`` gives the logical-axes tree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.models.layers import _dense_init, _dtype, gelu, silu

Params = Dict[str, Any]


def init_moe(gen: Optional[torch.Generator], cfg: ModelConfig) -> Params:
    """Router (D, E) f32; experts (E, D, F), (E, F, D) in ``cfg.dtype``;
    the shared experts' dense MLP when the config has them."""
    m = cfg.moe
    d = cfg.d_model
    dt = _dtype(cfg)
    p = {
        "router": _dense_init(gen, (d, m.n_experts), d, torch.float32),
        "w_gate": _dense_init(gen, (m.n_experts, d, m.d_expert), d, dt),
        "w_up": _dense_init(gen, (m.n_experts, d, m.d_expert), d, dt),
        "w_down": _dense_init(gen, (m.n_experts, m.d_expert, d), m.d_expert,
                              dt),
    }
    if m.n_shared_experts:
        f = m.n_shared_experts * m.d_expert
        p["shared"] = {"w_gate": _dense_init(gen, (d, f), d, dt),
                       "w_up": _dense_init(gen, (d, f), d, dt),
                       "w_down": _dense_init(gen, (f, d), f, dt)}
    return p


def moe_axes(cfg: ModelConfig) -> Params:
    """``init_moe``'s logical axes.  ``experts`` wins the model axis when
    n_experts divides it (expert parallel, kimi-k2); otherwise
    ``expert_mlp`` takes it (tensor parallel inside each expert, grok-1's
    8 experts): ``sharding.rules.logical_spec`` uses a mesh axis once per
    tensor, which makes the fallback automatic."""
    ax = {"router": ("embed", "experts"),
          "w_gate": ("experts", "expert_embed", "expert_mlp"),
          "w_up": ("experts", "expert_embed", "expert_mlp"),
          "w_down": ("experts", "expert_mlp", "expert_embed")}
    if cfg.moe.n_shared_experts:
        ax["shared"] = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                        "w_down": ("mlp", "embed")}
    return ax


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    cap = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, ((cap + 7) // 8) * 8)


def route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, D) -> (gates (T, k) f32 renormalised, expert ids (T, k) int32,
    the Switch-style load-balance aux term E * sum_e f_e * p_e).  The gates
    and p_e carry the router's gradient; f_e, read from the ids, none."""
    m = cfg.moe
    logits = x.float() @ router                                  # (T, E) f32
    gates, eids = K.moe_router_diff(logits, m.top_k)
    probs = torch.softmax(logits, dim=-1)
    pe = probs.mean(dim=0)
    fe = torch.zeros_like(logits).scatter_(1, eids.long(), 1.0).mean(dim=0)
    aux = m.n_experts * torch.sum(pe * fe)
    return gates, eids, aux


def dispatch_indices(eids: torch.Tensor, n_experts: int, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based slot assignment over capacity groups.

    eids (T, k) int, or (G, T, k) for G groups, -> (slots (G * T * k,)
    int64, keep (G * T * k,) bool).  Within a group, a choice's position is
    its rank among the group's choices of the same expert, in token order
    (stable argsort, then ``searchsorted`` for each expert's first rank);
    slot = e * G * C + g * C + position, and a choice past the capacity C
    goes to the dummy slot E * G * C.  With one group this is the JAX
    package's ``dispatch_indices``."""
    if eids.dim() == 2:
        eids = eids[None]
    g = eids.shape[0]
    flat = eids.reshape(g, -1).long()                            # (G, n)
    n = flat.shape[1]
    order = torch.argsort(flat, dim=1, stable=True)
    sorted_eid = torch.gather(flat, 1, order)
    experts = torch.arange(n_experts, device=flat.device).expand(g, -1)
    seg_start = torch.searchsorted(sorted_eid, experts.contiguous())
    pos_sorted = (torch.arange(n, device=flat.device)
                  - torch.gather(seg_start, 1, sorted_eid))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = pos < capacity
    group = torch.arange(g, device=flat.device)[:, None]
    slots = torch.where(keep, flat * (g * capacity) + group * capacity + pos,
                        n_experts * g * capacity)
    return slots.reshape(-1), keep.reshape(-1)


def moe_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor,
            per_row: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux).  ``per_row`` makes each batch row
    a capacity group of its own (see the module docstring).

    Rounding as in the JAX package: the gated expert activation is
    ``silu(x @ w_gate) * (x @ w_up)`` with each op rounded to x's dtype, and
    the combine casts ``gates * keep`` to x's dtype before the product and
    the sum over the k choices."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    gates, eids, aux = route(cfg, p["router"], xt)
    groups = b if per_row else 1
    c = expert_capacity(cfg, t // groups)
    slots, keep = dispatch_indices(eids.reshape(groups, t // groups, m.top_k),
                                   m.n_experts, c)
    rows = m.n_experts * groups * c

    # scatter tokens (repeated per chosen expert) into the dispatch buffer;
    # dropped choices all land on the dummy last row, which is discarded, so
    # the copy (never an accumulating scatter) may take them in any order
    buf = torch.zeros((rows + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slots, xt.repeat_interleave(m.top_k, dim=0))
    ebuf = buf[:rows].reshape(m.n_experts, groups * c, d)
    h = _act(cfg)(torch.bmm(ebuf, p["w_gate"])) * torch.bmm(ebuf, p["w_up"])
    out = torch.bmm(h, p["w_down"])

    # gather back + top-k weighted combine
    out_flat = torch.cat([out.reshape(rows, d),
                          torch.zeros((1, d), dtype=out.dtype,
                                      device=out.device)])
    per_choice = out_flat[slots]                                 # (T*k, D)
    w = (gates.reshape(-1) * keep.float()).to(x.dtype)
    y = (per_choice * w[:, None]).reshape(t, m.top_k, d).sum(dim=1)

    if m.n_shared_experts:
        sp = p["shared"]
        hs = _act(cfg)(xt @ sp["w_gate"]) * (xt @ sp["w_up"])
        y = y + hs @ sp["w_down"]
    return y.reshape(b, s, d), aux


def _act(cfg: ModelConfig):
    return gelu if cfg.mlp_activation == "gelu" else silu

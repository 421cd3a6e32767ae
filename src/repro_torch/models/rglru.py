"""RG-LRU recurrent block of RecurrentGemma / Griffin (the port of
``repro.models.rglru``).

Block: ``gelu(x W_g)`` times the RG-LRU over ``causal_conv(x W_r)``, then
the out-projection.  Decode carries the f32 state ``h`` and the conv's last
three inputs (``init_rglru_cache``, ``rglru_decode_step``), updated in
place.

The scan.  The JAX package runs the recurrence h_t = a_t h_{t-1} + b_t
with ``lax.associative_scan``, which has no Pallas kernel.  Here it is a
chunked closed form (``linear_scan``), with no loop over time: within a
chunk of ``SCAN_CHUNK`` steps, h_t = sum_{s <= t} exp(L_t - L_s) b_s, L the
chunk's cumulative sum of log a; the chunks' end states obey the same
recurrence one level up (decay exp(L_end), input the chunk's own end
state), which the function solves by calling itself; each chunk then adds
exp(L_t) times the state before it.  log a <= 0, so every kept exponent is
<= 0; the pairs s > t, whose exponents are positive and would overflow,
are set to -inf before ``exp`` (their value and gradient are 0, never
0 * inf).  Memory is O(S * SCAN_CHUNK * width), levels log_CHUNK(S).

Rounding places, as the JAX package's model runs compiled by XLA on its
CPU backend in bf16: the two input projections round to the activation
dtype, and so does every op of the conv but the SiLU's last product,
which ``_gates`` reads in f32 and XLA therefore leaves unrounded in a
forward pass (its excess precision), though not where autograd saves it
(``_conv``); ``gelu`` runs in f32 on the rounded product; the gates'
products ``x @ w_a`` and ``x @ w_x`` are f32 matmuls (PyTorch's default
keeps them IEEE f32 on the card: ``allow_tf32`` is off unless a caller
turns it on); ``gelu * h`` is rounded to the activation dtype before
``w_out``.  What is left against the compiled reference is sum order
(``tests/test_torch_blocks_groups.py``): the scan's, at most 1.5e-6 of
its rms in f32, and the bf16 products'; an ulp flip of ``x @ w_rec``
(~0.01 % of the conv's outputs) is carried along time by the recurrence,
so the block reads up to 1.2 % of its outputs off and 0.17 % beyond an
ulp.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (_dense_init, _device, _dtype, fan,
                                       gelu, saves_for_backward)
from repro_torch.models.ssm import _causal_conv

Params = Dict[str, Any]

_C = 8.0            # RG-LRU temperature constant (Griffin eq. 4)
CONV_WIDTH = 4
# the chunk length: forward and backward at seq 4096 and width 2560 on an
# H100 took 4.61-4.65 ms at chunk 8 (4 levels) in every run, 7.1 at 16 and
# 23.3 at 64; chunks 2-4 took 3.8-13.4 ms, set by the host's launch rate
# (chip_smoke.py phase 26, PERF.md)
SCAN_CHUNK = 8


def init_rglru(gen: Optional[torch.Generator], cfg: ModelConfig) -> Params:
    """Leaves as the JAX package's: the projections, conv and gate weights
    in ``cfg.dtype``; ``b_a``, ``b_x`` and ``lam`` f32 (``lam`` so that
    a^c spans (0.9, 0.999) across the width, per Griffin).  The LRU width
    is d_model (RecurrentGemma-2B)."""
    d = dr = cfg.d_model
    dt = _dtype(cfg)
    f32 = dict(dtype=torch.float32, device=_device(gen))
    lam = torch.linspace(0.9, 0.999, dr, **f32) ** -(1.0 / _C) - 1.0 + 1e-8
    return {
        "w_gelu": _dense_init(gen, (d, dr), d, dt),
        "w_rec": _dense_init(gen, (d, dr), d, dt),
        "conv_w": _dense_init(gen, (CONV_WIDTH, dr), CONV_WIDTH, dt),
        "conv_b": torch.zeros((dr,), dtype=dt, device=_device(gen)),
        "w_a": _dense_init(gen, (dr, dr), dr, dt),       # recurrence gate
        "b_a": torch.zeros((dr,), **f32),
        "w_x": _dense_init(gen, (dr, dr), dr, dt),       # input gate
        "b_x": torch.zeros((dr,), **f32),
        "lam": torch.log(torch.expm1(lam)),
        "w_out": _dense_init(gen, (dr, d), dr, dt),
    }


def rglru_axes(cfg: ModelConfig) -> Params:
    return {"w_gelu": ("embed", "rnn_width"), "w_rec": ("embed", "rnn_width"),
            "conv_w": (None, "rnn_width"), "conv_b": ("rnn_width",),
            "w_a": ("rnn_width", "rnn_width"), "b_a": ("rnn_width",),
            "w_x": ("rnn_width", "rnn_width"), "b_x": ("rnn_width",),
            "lam": ("rnn_width",), "w_out": ("rnn_width", "embed")}


def _gates(p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, dr) -> (log_a, gated input), both f32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(xf @ p["w_x"].float() + p["b_x"])
    log_a = -_C * F.softplus(p["lam"]) * r                 # (B, S, dr) <= 0
    a2 = torch.exp(2.0 * log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * xf)
    return log_a, gated_x


def _scan_block(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = sum_{s <= t} exp(L_t - L_s) b_s over dim 1 (h_0 = 0), L the
    cumulative sum of log_a: one (B, Q, Q, D) pair tensor, the pairs
    s > t at -inf before ``exp``."""
    L = torch.cumsum(log_a, dim=1)
    q = log_a.shape[1]
    keep = torch.ones((q, q), dtype=torch.bool, device=b.device).tril()
    expo = L[:, :, None, :] - L[:, None, :, :]              # (B, t, s, D)
    expo = torch.where(keep[None, :, :, None], expo, float("-inf"))
    return (torch.exp(expo) * b[:, None, :, :]).sum(dim=2)


def linear_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t along dim 1 of (B, S, D) f32
    tensors, from h_0 = 0 (see the module docstring)."""
    bsz, s, d = b.shape
    chunk = SCAN_CHUNK
    if s <= chunk:
        return _scan_block(log_a, b)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:             # trailing steps with a = 1, b = 0 change no h_t
        log_a = F.pad(log_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
    la = log_a.reshape(bsz * nc, chunk, d)
    h = _scan_block(la, b.reshape(bsz * nc, chunk, d)).reshape(
        bsz, nc, chunk, d)
    L = torch.cumsum(la, dim=1).reshape(bsz, nc, chunk, d)
    # the state at each chunk's end, then the one before each chunk
    ends = linear_scan(L[:, :, -1], h[:, :, -1].contiguous())
    before = F.pad(ends[:, :-1], (0, 0, 1, 0))
    h = h + torch.exp(L) * before[:, :, None, :]
    return h.reshape(bsz, nc * chunk, d)[:, :s]


def _conv(p: Params, x_res: torch.Tensor,
          tail: Optional[torch.Tensor] = None):
    """The input branch's projection and causal conv -> (xr, new tail).
    Where autograd saves the conv for the backward (training), its SiLU's
    last product rounds to the activation dtype; elsewhere (eval, prefill,
    decode, and the first forward of a checkpointed region) it stays f32.
    So does the JAX package's compiled model: a forward alone hands that
    product to ``_gates``' f32 upcast unrounded, but under
    ``jax.value_and_grad`` it is a residual of the backward pass, and XLA
    materialises it in bf16; under ``jax.checkpoint`` the forward keeps
    no residual and the product f32, and the backward's recompute rounds
    it (``layers.saves_for_backward``)."""
    xw = x_res @ p["w_rec"]
    return _causal_conv(xw, p["conv_w"], p["conv_b"], tail=tail,
                        f32_out=not saves_for_backward(xw))


def rglru_forward(cfg: ModelConfig, p: Params,
                  x_res: torch.Tensor) -> torch.Tensor:
    """x_res (B, S, D) -> (B, S, D).  The conv's last product stays f32
    unless autograd saves it (``_conv``)."""
    dt = p["w_out"].dtype
    xg, xc = fan(x_res, 2, dt)
    branch_g = gelu((xg @ p["w_gelu"]).float())
    xr, _ = _conv(p, xc)
    log_a, b = _gates(p, xr)
    h = linear_scan(log_a, b)
    return (branch_g * h).to(dt) @ p["w_out"]


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Params:
    """Decode state: ``h`` (B, dr) f32 and the conv's last W-1 inputs
    ``conv_tail`` (B, W-1, dr) in ``dtype``, all zeros."""
    dr = cfg.d_model
    return {
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
        "conv_tail": torch.zeros((batch, CONV_WIDTH - 1, dr), dtype=dtype,
                                 device=device),
    }


def rglru_decode_step(cfg: ModelConfig, p: Params, cache: Params,
                      x_res: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One recurrent step.  x_res (B, 1, D) -> (out (B, 1, D), cache), the
    new state and conv tail written into ``cache``'s tensors in place."""
    branch_g = gelu((x_res @ p["w_gelu"]).float())
    xr, new_tail = _conv(p, x_res, cache["conv_tail"])
    log_a, b = _gates(p, xr)
    h = torch.exp(log_a[:, 0]) * cache["h"] + b[:, 0]
    cache["h"].copy_(h)
    cache["conv_tail"].copy_(new_tail)
    return (branch_g * h[:, None, :]).to(x_res.dtype) @ p["w_out"], cache

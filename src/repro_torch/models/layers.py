"""Building blocks of the dense decoder (the port of ``repro.models.layers``).

Conventions, as in the JAX package:
  * params are nested dicts of tensors; init functions draw from one
    ``torch.Generator`` on the CPU (the JAX package splits PRNG keys, so the
    two inits differ; tests hand the reference's init over);
  * activations run in ``cfg.dtype`` (bf16 by default), norm and softmax
    statistics in f32, logits in f32;
  * shapes: tokens (B, S); hidden (B, S, D); attention heads (B, S, H, hd).

Attention on the self-attention train/prefill branch always goes through
``kernels.ops.flash_attention_diff`` (the CUDA kernel on the card, its plain
version on the CPU).  The decode cache, cross-attention and a bidirectional
prefix are not ported and raise.  The sharding hints of the JAX package
(``constrain``) are the identity on one card and are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K

Params = Dict[str, Any]

# --------------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------------- #


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dense_init(gen: torch.Generator, shape, in_axis_size: int,
                dtype: torch.dtype) -> torch.Tensor:
    scale = in_axis_size ** -0.5
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * scale).to(dtype)


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 256 (as the JAX package pads it)."""
    return ((cfg.vocab_size + 255) // 256) * 256


def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"table": _dense_init(gen, (padded_vocab(cfg), cfg.d_model),
                                 cfg.d_model, _dtype(cfg))}


# --------------------------------------------------------------------------- #
# normalization
# --------------------------------------------------------------------------- #


def init_rmsnorm(cfg: ModelConfig) -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale)).to(x.dtype)


# --------------------------------------------------------------------------- #
# rotary position embedding
# --------------------------------------------------------------------------- #


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  Half-split rotation in
    f32, output in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs          # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Per-layer attention behaviour."""
    causal: bool = True
    window: Optional[int] = None            # sliding window (None = full)
    softcap: Optional[float] = None
    prefix_len: int = 0                     # bidirectional prefix (prefix-LM)


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = _dtype(cfg)
    return {
        "wq": _dense_init(gen, (d, cfg.n_heads, hd), d, dt),
        "wk": _dense_init(gen, (d, cfg.n_kv_heads, hd), d, dt),
        "wv": _dense_init(gen, (d, cfg.n_kv_heads, hd), d, dt),
        "wo": _dense_init(gen, (cfg.n_heads, hd, d), cfg.n_heads * hd, dt),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one (B*S, D) @ (D, H*hd) product."""
    b, s, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).reshape(b, s, w.shape[1],
                                                   w.shape[2])


def multihead_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                        spec: AttnSpec, positions: torch.Tensor,
                        kv_x: Optional[torch.Tensor] = None,
                        cache: Optional[Params] = None) -> torch.Tensor:
    """GQA self-attention over the full sequence (train/prefill), through
    the flash kernel.  Query head h = kv_idx * G + g reads kv head
    h // G, the order of the JAX package's grouped reshape."""
    if cache is not None:
        raise NotImplementedError(
            "multihead_attention: the decode cache is not ported to PyTorch "
            "yet — ROADMAP Queue A item 7 (serving)")
    if kv_x is not None:
        raise NotImplementedError(
            "multihead_attention: cross-attention is not ported to PyTorch "
            "yet — ROADMAP Queue A item 6 (the encdec/audio family) and "
            "item 7 (serving)")
    if spec.prefix_len:
        raise NotImplementedError(
            "multihead_attention: a bidirectional prefix is not ported to "
            "PyTorch yet — ROADMAP Queue A item 6 (the vlm family)")
    b, s, _ = x.shape
    q = apply_rope(_project(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
    v = _project(x, p["wv"])
    # (B, S, H, hd) -> (B, H, S, hd) views; the kernel writes its output in
    # q's (B, S, H, hd) layout, so the swap back is free
    out = K.flash_attention_diff(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=spec.causal,
                                 window=spec.window, softcap=spec.softcap)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * q.shape[-1])
    return out @ p["wo"].reshape(-1, p["wo"].shape[-1])


# --------------------------------------------------------------------------- #
# gated MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------------- #


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = _dtype(cfg)
    return {"w_gate": _dense_init(gen, (d, f), d, dt),
            "w_up": _dense_init(gen, (d, f), d, dt),
            "w_down": _dense_init(gen, (f, d), f, dt)}


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP.  The activation and the gate product run in f32 with one
    rounding to x's dtype, as XLA fuses them in the JAX package (rounding
    after each op moves a bf16 loss by ~1e-3)."""
    gate = (x @ p["w_gate"]).float()
    # jax.nn.gelu defaults to the tanh approximation
    act = (F.gelu(gate, approximate="tanh") if cfg.mlp_activation == "gelu"
           else F.silu(gate))
    h = (act * (x @ p["w_up"]).float()).to(x.dtype)
    return h @ p["w_down"]


# --------------------------------------------------------------------------- #
# logits / loss
# --------------------------------------------------------------------------- #


def lm_logits(cfg: ModelConfig, embed_table: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: logits in x's dtype, then f32; padded vocab columns
    masked to -1e30."""
    logits = (x @ embed_table.to(x.dtype).t()).float()
    if cfg.final_logit_softcap is not None:
        logits = (torch.tanh(logits / cfg.final_logit_softcap)
                  * cfg.final_logit_softcap)
    pv = logits.shape[-1]
    if pv != cfg.vocab_size:
        col = torch.arange(pv, device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return logits


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0]
    if mask is None:
        return -torch.mean(ll)
    mask = mask.float()
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)

"""Building blocks of the dense decoder (the port of ``repro.models.layers``).

Conventions, as in the JAX package:
  * params are nested dicts of tensors; init functions draw from one
    ``torch.Generator`` on its own device, each leaf cast to its dtype as it
    is drawn (the JAX package splits PRNG keys, so the two inits differ;
    tests hand the reference's init over).  ``gen=None`` builds the leaves
    on the ``meta`` device: shapes and dtypes, nothing allocated;
  * beside each ``init_*`` an ``*_axes(cfg)`` function gives the second
    half of the JAX package's ``init_*`` result: the logical-axes tree, the
    params tree's structure with a tuple of logical axis names per leaf
    (``sharding.rules``), built from ``cfg`` alone;
  * activations run in ``cfg.dtype`` (bf16 by default), norm and softmax
    statistics in f32, logits in f32;
  * shapes: tokens (B, S); hidden (B, S, D); attention heads (B, S, H, hd).

Attention on the self-attention train/prefill branch goes through
``kernels.ops.flash_attention_diff`` (the CUDA kernel on the card, its plain
version on the CPU), causal or not (the enc-dec encoder's), whatever
``cfg.attn_impl`` says.  A decode step against a cache, cross-attention and
a bidirectional prefix (the prefix-LM) are einsums, as in the JAX package,
which keeps all three off its Pallas path too; the prefix-LM with
``attn_impl="chunked"`` runs ``chunked_attention``, the reference's online
softmax over kv blocks, in plain PyTorch.  The sharding hints of the JAX package (``constrain``) are the
identity on one card and are not threaded through the model code (the
sharded execution item of the roadmap).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K

Params = Dict[str, Any]

# --------------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------------- #


class _PerOp(torch.autograd.Function):
    """An activation whose forward is a chain of ops each rounded to x's
    dtype (the JAX package's CPU backend evaluates them so) and whose
    backward is the gradient of the smooth f32 formula: the chain's own
    autograd would give 0 * inf = NaN where ``exp(-x)`` overflows."""

    @staticmethod
    def forward(ctx, x, chain, smooth):
        ctx.save_for_backward(x)
        ctx.smooth = smooth
        return chain(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xf = x.detach().float().requires_grad_()
            (gx,) = torch.autograd.grad(ctx.smooth(xf), xf, g.float())
        return gx.to(x.dtype), None, None


def _silu_chain(x: torch.Tensor) -> torch.Tensor:
    return x * torch.reciprocal(1 + torch.exp(-x))


def _silu_chain_f32(x: torch.Tensor) -> torch.Tensor:
    # the bf16 factors' product is exact in f32: the multiply promotes
    return x.float() * torch.reciprocal(1 + torch.exp(-x))


def _gelu_chain(x: torch.Tensor) -> torch.Tensor:
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the JAX package's CPU backend evaluates it:
    ``x * (1 / (1 + exp(-x)))``, each op rounded to x's dtype (bit for bit
    in bf16; ``F.silu`` rounds once and differs in ~40% of bf16 values)."""
    return _PerOp.apply(x, _silu_chain, F.silu)


def silu_f32(x: torch.Tensor) -> torch.Tensor:
    """``silu`` with its last product, ``x * (1 / (1 + exp(-x)))``, left in
    f32: where the reference's compiled caller reads the activation in
    f32, XLA drops the product's rounding to x's dtype (its excess
    precision), and so does this."""
    return _PerOp.apply(x, _silu_chain_f32, F.silu)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form) as the JAX package's CPU backend
    evaluates it: ``x * (0.5 * (1 + tanh(c * (x + k * x^3))))`` with the
    constants and every op rounded to x's dtype (bit for bit in bf16)."""
    return _PerOp.apply(x, _gelu_chain,
                        lambda v: F.gelu(v, approximate="tanh"))


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _device(gen: Optional[torch.Generator]) -> torch.device:
    """Where init puts its leaves: the generator's device, or ``meta``."""
    return torch.device("meta") if gen is None else gen.device


def _dense_init(gen: Optional[torch.Generator], shape, in_axis_size: int,
                dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1/in_axis_size) drawn in f32 on the generator's device, scaled
    in place and cast to ``dtype`` (one f32 leaf alive at a time)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(in_axis_size ** -0.5).to(dtype)


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 256 (as the JAX package pads it)."""
    return ((cfg.vocab_size + 255) // 256) * 256


def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"table": _dense_init(gen, (padded_vocab(cfg), cfg.d_model),
                                 cfg.d_model, _dtype(cfg))}


def embedding_axes(cfg: ModelConfig) -> Params:
    return {"table": ("vocab", "embed")}


# --------------------------------------------------------------------------- #
# normalization
# --------------------------------------------------------------------------- #


def init_rmsnorm(cfg: ModelConfig, device=None) -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)


RMSNORM_AXES = ("embed",)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """RMS norm in f32, output in ``dtype`` (default x's)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale)).to(dtype or x.dtype)


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


def attention_axes(cfg: ModelConfig) -> Params:
    """Self- and cross-attention share one layout."""
    return {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one (B*S, D) @ (D, H*hd) product."""
    b, s, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).reshape(b, s, w.shape[1],
                                                   w.shape[2])


def attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
              spec: AttnSpec) -> torch.Tensor:
    """Boolean mask (..., Sq, Sk), True = attend (``repro.models.layers.
    _attn_mask``)."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    if spec.causal:
        mask = k <= q
        if spec.prefix_len:
            mask = mask | ((q < spec.prefix_len) & (k < spec.prefix_len))
    else:
        mask = torch.ones_like(k <= q)
    if spec.window is not None:
        mask = mask & ((q - k) < spec.window)
    return mask


def cached_attention(cfg: ModelConfig, wo: torch.Tensor, q: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor],
                     softcap: Optional[float]) -> torch.Tensor:
    """Queries (B, Sq, H, hd) against keys and values (B, W, Hk, hd) (a
    cache's, the encoder's or the sequence's own), then the out-projection:
    the JAX package's einsum path.  Scores
    come out of the product in the cache's dtype, then f32 and scaled;
    softcap, then the -1e30 mask; the probabilities are cast to v's dtype
    before the product with v.  ``mask`` broadcasts to (B, Hk, Sq, G, W);
    None attends everywhere (cross-attention)."""
    b, sq, _, hd = q.shape
    qg = q.reshape(b, sq, cfg.n_kv_heads, cfg.q_per_kv, hd)
    scores = torch.einsum("bsngk,btnk->bnsgt", qg, k).float() * hd ** -0.5
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bnsgt,btnk->bsngk", probs, v)
    return out.reshape(b, sq, cfg.n_heads * hd) @ wo.reshape(-1,
                                                              wo.shape[-1])


def chunked_attention(cfg: ModelConfig, wo: torch.Tensor, q: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor,
                      spec: AttnSpec) -> torch.Tensor:
    """Online-softmax self-attention over ``cfg.attn_chunk``-row kv blocks
    (``repro.models.layers._chunked_attention``), then the out-projection.
    q (B, S, H, hd) against k, v (B, S, Hk, hd), positions 0..S-1: kv is
    padded to a whole block; q, scaled by ``hd ** -0.5``, and each block
    go to f32 before the product; softcap, then the causal / prefix /
    window / padding mask with the -1e30 fill; the running max, sum and
    accumulator stay f32, masked entries add zero (a fully masked row
    stays at zero), and the output is cast to v's dtype only at the end.
    Plain PyTorch: the reference runs it off its Pallas path."""
    b, sq, _, hd = q.shape
    n, g = cfg.n_kv_heads, cfg.q_per_kv
    sk = k.shape[1]
    blk = min(cfg.attn_chunk, sk)
    pad = (-sk) % blk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.reshape(b, sq, n, g, hd).float() * hd ** -0.5
    rows = torch.arange(sq, dtype=torch.int32, device=q.device)[:, None]
    m = torch.full((b, n, sq, g), -1e30, device=q.device)
    l = torch.zeros((b, n, sq, g), device=q.device)
    acc = torch.zeros((b, n, sq, g, hd), device=q.device)
    for start in range(0, sk + pad, blk):
        s = torch.einsum("bsngk,btnk->bnsgt", qf,
                         k[:, start:start + blk].float())
        if spec.softcap is not None:
            s = torch.tanh(s / spec.softcap) * spec.softcap
        cols = start + torch.arange(blk, dtype=torch.int32,
                                    device=q.device)[None, :]
        mask = (cols < sk).expand(sq, blk)
        if spec.causal:
            mask = mask & (cols <= rows)
            if spec.prefix_len:
                mask = mask | ((rows < spec.prefix_len)
                               & (cols < spec.prefix_len) & (cols < sk))
        if spec.window is not None:
            mask = mask & ((rows - cols) < spec.window)
        s = torch.where(mask[None, None, :, None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(s > -1e29, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bnsgt,btnk->bnsgk", p, v[:, start:start + blk].float())
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)
    return out.to(v.dtype).reshape(b, sq, cfg.n_heads * hd) @ wo.reshape(
        -1, wo.shape[-1])


def multihead_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                        spec: AttnSpec, positions: torch.Tensor,
                        kv_x: Optional[torch.Tensor] = None,
                        cache: Optional[Params] = None,
                        cache_pos=None
                        ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA attention -> (y, new cache).  Query head h = kv_idx * G + g
    reads kv head h // G, the order of the JAX package's grouped reshape.

    Without a cache it runs over the full sequence (train/prefill) through
    the flash kernel and returns no cache, whatever ``cfg.attn_impl``
    says (the JAX package's branch order under its Pallas backend); with
    ``spec.prefix_len`` (the prefix-LM's bidirectional prefix) through
    ``chunked_attention`` when ``cfg.attn_impl == "chunked"``, else plain
    attention on the (Sq, Sk) mask of ``attn_mask``.  With ``kv_x`` (B, Sk, D) it is
    cross-attention: q from x, k and v from ``kv_x``, no rope on either
    side and no mask, plain attention.  With ``cache`` {k, v (B, W, Hk,
    hd)} it is one step of x (B, Sq, D) at ``cache_pos``: the new keys and
    values are written into the cache's tensors in place at rows
    ``cache_pos`` onward (clamped to fit, as ``dynamic_update_slice``
    clamps), and attention spans the cache with rows past the step masked."""
    b, s, _ = x.shape
    if kv_x is not None:
        return cached_attention(cfg, p["wo"], _project(x, p["wq"]),
                                _project(kv_x, p["wk"]),
                                _project(kv_x, p["wv"]), None,
                                spec.softcap), None
    q = apply_rope(_project(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
    v = _project(x, p["wv"])
    if cache is not None:
        w = cache["k"].shape[1]
        start = min(max(int(cache_pos), 0), w - s)
        cache["k"][:, start:start + s] = k.to(cache["k"].dtype)
        cache["v"][:, start:start + s] = v.to(cache["v"].dtype)
        k_pos = torch.arange(w, dtype=torch.int32, device=x.device)
        mask = attn_mask(positions, k_pos.expand(b, w), spec)
        mask = mask & (k_pos <= int(cache_pos))
        y = cached_attention(cfg, p["wo"], q, cache["k"], cache["v"],
                             mask[:, None, :, None, :], spec.softcap)
        return y, {"k": cache["k"], "v": cache["v"]}
    if spec.prefix_len and cfg.attn_impl == "chunked":
        return chunked_attention(cfg, p["wo"], q, k, v, spec), None
    if spec.prefix_len:
        # batch-free (Sq, Sk) mask, as the JAX package builds it
        iota = torch.arange(s, dtype=torch.int32, device=x.device)
        mask = attn_mask(iota, iota, spec)[None, None, :, None, :]
        return cached_attention(cfg, p["wo"], q, k, v, mask,
                                spec.softcap), None
    # (B, S, H, hd) -> (B, H, S, hd) views; the kernel writes its output in
    # q's (B, S, H, hd) layout, so the swap back is free
    out = K.flash_attention_diff(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=spec.causal,
                                 window=spec.window, softcap=spec.softcap)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * q.shape[-1])
    return out @ p["wo"].reshape(-1, p["wo"].shape[-1]), None


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


def mlp_axes(cfg: ModelConfig) -> Params:
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP, ``act(x @ w_gate) * (x @ w_up) @ w_down`` with every op
    rounded to x's dtype, bit for bit the JAX package's on its CPU backend
    (jax 0.9.0 does not fuse the chain into one f32 rounding)."""
    act = gelu if cfg.mlp_activation == "gelu" else silu
    return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


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

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
  * the backward rounds where the reference's compiled backward rounds
    (``tests/test_torch_blocks_grad*.py``): the activations' pullbacks
    are ``jax.vjp``'s op chains (``_PerOp``), a norm's users' cotangents
    meet in f32 (``rms_norm(held=)``, ``fan``), a broadcast operand's
    gradient sums add by add in bf16 (``broadcast_mul``), and the input
    gradient of a norm that reads a bf16 residual sum in f32 rounds before
    the residual's joins it (``round_grad``, ``transformer.residual_norm``);
  * shapes: tokens (B, S); hidden (B, S, D); attention heads (B, S, H, hd).

Attention on the self-attention train/prefill branch goes through
``kernels.ops.flash_attention_diff`` (the CUDA kernel on the card, its plain
version on the CPU), causal or not (the enc-dec encoder's), whatever
``cfg.attn_impl`` says.  A decode step against a cache, cross-attention and
a bidirectional prefix (the prefix-LM) are einsums, as in the JAX package,
which keeps all three off its Pallas path too; the prefix-LM with
``attn_impl="chunked"`` runs ``chunked_attention``, the reference's online
softmax over kv blocks, in plain PyTorch.

The JAX package's sharding hints (``constrain``) are threaded through the
dense family's train/prefill path and are the identity on one device.  On a
mesh of ranks (``sharding.rules.rank_mesh``) each rank holds its blocks of
the leaves, gathered over the batch axes by the caller (FSDP,
``transformer.forward``), so only the ``"model"`` split is left here:
attention is head-parallel where the heads split over ``"model"``,
context-parallel (this rank's query rows against the whole sequence's k and
v, ``flash_attention``'s ``q_offset``) under the ``q_seq: ("model",)``
override, and replicated otherwise; the MLP is column- then row-parallel;
the LM head is vocab-parallel, and ``softmax_cross_entropy`` takes the max,
the sum of exponentials and the label's logit over the vocab shards and the
mean over the batch axes by collectives, never gathering the logits.  A
tensor every rank holds whole enters a tensor-parallel region through
``psum_grad`` (its gradient summed over the ranks), and a row-parallel
product leaves through ``row_parallel``: its partial sums kept in f32,
psummed, and rounded to bf16 once, as the unsharded product rounds them
(a bf16 psum of bf16 partials puts ~7.5 % of a block's outputs more than
one ulp from the reference's, the f32 psum none more than the unsharded
product does: ``python tests/_torch_blocks.py --row-parallel``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.sharding import rules as SR

Params = Dict[str, Any]

# --------------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------------- #


class _PerOp(torch.autograd.Function):
    """An activation whose forward and backward are the JAX package's op
    chains as its CPU backend compiles them in bf16: each op rounded to
    x's dtype, the backward the chain ``jax.vjp`` builds from the
    forward's ops (``logistic``'s own ``y * (1 - y)``, ``tanh``'s
    ``1 - y^2``), never autograd through ``exp`` (0 * inf = NaN where
    ``exp(-x)`` overflows)."""

    @staticmethod
    def forward(ctx, x, chain, grad):
        ctx.save_for_backward(x)
        ctx.grad = grad
        return chain(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return ctx.grad(x, g), None, None


def _sigmoid_chain(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(1 + torch.exp(-x))


def _silu_chain(x: torch.Tensor) -> torch.Tensor:
    return x * _sigmoid_chain(x)


def _silu_chain_f32(x: torch.Tensor) -> torch.Tensor:
    # the bf16 factors' product is exact in f32: the multiply promotes
    return x.float() * _sigmoid_chain(x)


def _silu_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The pullback of ``x * logistic(x)``: ``g * s + (x * g) * (s * (1 -
    s))``, each op in x's dtype (the f32 cotangent of ``silu_f32`` is
    rounded first, as the transpose of the reference's upcast)."""
    g = g.to(x.dtype)
    s = _sigmoid_chain(x)
    return g * s + (x * g) * (s * (1 - s))


def _gelu_consts(x: torch.Tensor):
    return (torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype),
            torch.tensor(0.044715, dtype=x.dtype))


def _gelu_chain(x: torch.Tensor) -> torch.Tensor:
    c, k = _gelu_consts(x)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def _gelu_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The pullback of ``x * (0.5 * (1 + tanh(c * (x + k * x^3))))`` in
    the order ``jax.vjp`` builds it, each op in x's dtype: the cdf's term
    ``g * cdf``, then through tanh (``d + d * t`` with ``d = (x * g) *
    0.5 * (1 - t)``) and c to the inner sum's two terms, ``x`` and ``k *
    x^3`` (``(ct * k) * (x * x * 3)``), added in that order."""
    c, k = _gelu_consts(x)
    x2 = x * x
    t = torch.tanh(c * (x + k * (x2 * x)))
    d = ((x * g) * 0.5) * (1 - t)
    inner = (d + d * t) * c
    return (g * ((t + 1) * 0.5) + inner) + (inner * k) * (x2 * 3)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the JAX package's CPU backend evaluates it:
    ``x * (1 / (1 + exp(-x)))``, each op rounded to x's dtype (bit for bit
    in bf16; ``F.silu`` rounds once and differs in ~40% of bf16 values),
    and its pullback likewise (``_silu_grad``)."""
    return _PerOp.apply(x, _silu_chain, _silu_grad)


def silu_f32(x: torch.Tensor) -> torch.Tensor:
    """``silu`` with its last product, ``x * (1 / (1 + exp(-x)))``, left in
    f32: where the reference's compiled caller reads the activation in
    f32, XLA drops the product's rounding to x's dtype (its excess
    precision), and so does this."""
    return _PerOp.apply(x, _silu_chain_f32, _silu_grad)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form) as the JAX package's CPU backend
    evaluates it: ``x * (0.5 * (1 + tanh(c * (x + k * x^3))))`` with the
    constants and every op rounded to x's dtype (bit for bit in bf16), and
    its pullback likewise (``_gelu_grad``)."""
    return _PerOp.apply(x, _gelu_chain, _gelu_grad)


_CHECKPOINT = threading.local()


@contextlib.contextmanager
def checkpointed_forward():
    """The first forward of a checkpointed region (``transformer.
    remat_call``): autograd records it but saves nothing for the backward,
    which runs the region again (outside this context)."""
    prev = getattr(_CHECKPOINT, "on", False)
    _CHECKPOINT.on = True
    try:
        yield
    finally:
        _CHECKPOINT.on = prev


def saves_for_backward(x: torch.Tensor) -> bool:
    """Whether autograd keeps what is computed from x for the backward: x
    records a graph and no checkpointed region's first forward is running
    (there the reference's ``jax.checkpoint`` keeps no residual either)."""
    return x.requires_grad and not getattr(_CHECKPOINT, "on", False)


class _RoundGrad(torch.autograd.Function):
    """The identity, whose pullback rounds the cotangent to ``dtype`` and
    hands it on in x's dtype."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def round_grad(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x, with its gradient rounded to ``dtype`` where it leaves: where the
    reference's compiled backward materialises a cotangent in the
    activation dtype that the port's autograd would carry on in f32."""
    if dtype == x.dtype:
        return x
    return _RoundGrad.apply(x, dtype)


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


class _Broadcast(torch.autograd.Function):
    """x * w or x + w, w broadcast over x's ``dims``; the pullback onto w
    sums over them as the reference's transpose of the broadcast does
    (``ops.rounded_sum``: in the activation dtype, add by add)."""

    @staticmethod
    def forward(ctx, x, w, dims, mul):
        ctx.save_for_backward(x if mul else None, w if mul else None)
        ctx.dims, ctx.mul, ctx.shape = dims, mul, w.shape
        return x * w if mul else x + w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if ctx.mul:
            return (g * w, K.rounded_sum(g * x, ctx.dims).reshape(ctx.shape),
                    None, None)
        return g, K.rounded_sum(g, ctx.dims).reshape(ctx.shape), None, None


def broadcast_mul(x: torch.Tensor, w: torch.Tensor, dims) -> torch.Tensor:
    """x * w, w broadcast over x's ``dims``, its gradient summed as the
    reference's backward sums it (``_Broadcast``)."""
    return _Broadcast.apply(x, w, dims, True)


def broadcast_add(x: torch.Tensor, w: torch.Tensor, dims) -> torch.Tensor:
    """x + w, as ``broadcast_mul``."""
    return _Broadcast.apply(x, w, dims, False)


class _Held(torch.autograd.Function):
    """x rounded to ``dtype`` and held in x's dtype; the pullback passes
    the cotangent on as it comes."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Fan(torch.autograd.Function):
    """x in ``dtype``, once per user: distinct outputs, so that autograd
    hands each user's cotangent to ``backward`` on its own, each a view of
    one cast (a user that saves its input saves that one tensor)."""

    @staticmethod
    def forward(ctx, x, n, dtype, round_last):
        ctx.in_dtype, ctx.round_last = x.dtype, round_last
        y = x.to(dtype)
        return tuple(y.view_as(y) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        gs = [g for g in gs if g is not None]
        acc = gs[-1]
        for g in reversed(gs[1:-1]):
            acc = (acc.float() + g.float()).to(acc.dtype)
        if len(gs) > 1:
            acc = acc.float() + gs[0].float()
            if ctx.round_last:
                acc = acc.to(gs[0].dtype)
        return acc.to(ctx.in_dtype), None, None, None


def fan(x: torch.Tensor, n: int, dtype: torch.dtype,
        round_last: bool = False):
    """x cast to ``dtype`` for each of its ``n`` users, in the order the
    reference's code uses it.  In the backward the users' cotangents are
    summed as ``jax.vjp`` sums them, from the last user back, each partial
    sum rounded to ``dtype``; the last sum comes out unrounded in x's
    dtype (f32 where x is a norm's held output, ``rms_norm(held=)``), as
    XLA hands it to the norm's f32 pullback, unless ``round_last`` (the
    MoE FFN's four users, whose sum XLA materialises).  Every reader of a
    norm's held output takes it through here; for one user it is the
    cast."""
    if n == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        y = x.to(dtype)
        return (y,) * n
    return _Fan.apply(x, n, dtype, round_last)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             dtype: Optional[torch.dtype] = None,
             held: bool = False) -> torch.Tensor:
    """RMS norm in f32, output in ``dtype`` (default x's).  With ``held``,
    where autograd records it, the output is rounded to ``dtype`` but
    comes as f32, and each of its users casts it to its weights' dtype
    itself (``fan``: ``multihead_attention``, ``mlp``, the mixers,
    ``moe_ffn``): the users' cotangents then meet in f32, as the
    reference's compiled backward adds them before the norm's f32
    pullback reads their sum."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    out = normed * (1.0 + scale)
    dt = dtype or x.dtype
    if held and dt != out.dtype and torch.is_grad_enabled() and \
            out.requires_grad:
        return _Held.apply(out, dt)
    return out.to(dt)


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
    dt = p["wq"].dtype
    if kv_x is None and cache is None and not spec.prefix_len:
        if SR.rank_mesh() is not None:
            return _sharded_attention(cfg, p, x, spec, positions), None
        return _attention_core(cfg, x, p["wq"], p["wk"], p["wv"], p["wo"],
                               spec, positions), None
    if kv_x is not None:
        (xq,), (xk, xv) = fan(x, 1, dt), fan(kv_x, 2, dt)
        return cached_attention(cfg, p["wo"], _project(xq, p["wq"]),
                                _project(xk, p["wk"]), _project(xv, p["wv"]),
                                None, spec.softcap), None
    xq, xk, xv = fan(x, 3, dt)
    q = apply_rope(_project(xq, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(xk, p["wk"]), positions, cfg.rope_theta)
    v = _project(xv, p["wv"])
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
    if cfg.attn_impl == "chunked":              # the prefix-LM
        return chunked_attention(cfg, p["wo"], q, k, v, spec), None
    # batch-free (Sq, Sk) mask, as the JAX package builds it
    iota = torch.arange(s, dtype=torch.int32, device=x.device)
    mask = attn_mask(iota, iota, spec)[None, None, :, None, :]
    return cached_attention(cfg, p["wo"], q, k, v, mask, spec.softcap), None


def _whole(w: torch.Tensor, dim: int, n: int, partial: bool) -> torch.Tensor:
    """w with all ``n`` entries of ``dim`` on every rank of the model axis:
    gathered where the leaf splits there, else as it is.  ``partial``: the
    ranks use it for different work (context parallelism), so its
    gradient is each rank's part: the gather's backward reduce-scatters,
    and a whole leaf's gradient is summed (``psum_grad``)."""
    if w.shape[dim] == n:
        return SR.psum_grad(w, SR.TP_AXIS) if partial else w
    return SR.all_gather(w, SR.TP_AXIS, dim, partial_grad=partial)


class _F32Product(torch.autograd.Function):
    """``a @ w`` with its f32 sum unrounded (the card's bf16 GEMM with an
    f32 output; elsewhere the f32 product of the same values); the
    backward's products in a's dtype, as the plain product's are."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        a2 = a.reshape(-1, a.shape[-1])
        if a.dtype == torch.float32:
            y = a2 @ w
        elif a.device.type == "cpu":
            y = a2.float() @ w.float()
        else:
            y = torch.mm(a2, w, out_dtype=torch.float32)
        return y.view(*a.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        return (g @ w.t(), a.reshape(-1, a.shape[-1]).t()
                @ g.reshape(-1, g.shape[-1]))


def row_parallel(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` whose contraction is split over the model axis (this
    rank's block of each): the f32 partial sums psummed, then rounded to
    a's dtype once."""
    y = SR.constrain(_F32Product.apply(a, w), ("data", None, "embed_act"),
                     partial=(SR.TP_AXIS,))
    return y.to(a.dtype)


def _attention_core(cfg: ModelConfig, x: torch.Tensor, wq, wk, wv, wo,
                    spec: AttnSpec, positions: torch.Tensor,
                    rows: Optional[Tuple[int, int]] = None,
                    split: bool = False) -> torch.Tensor:
    """Projections, rope, flash and the out-projection of ``x`` through
    the given (local) weights; ``rows`` = (first, count): only those query
    rows, against every row's k and v; ``split``: the heads are this
    rank's of a model-axis split, the out-projection ``row_parallel``."""
    b = x.shape[0]
    xq, xk, xv = fan(x, 3, wq.dtype)
    q_pos, r0 = positions, 0
    if rows is not None:
        r0, n = rows
        xq, q_pos = xq[:, r0:r0 + n], positions[:, r0:r0 + n]
    q = apply_rope(_project(xq, wq), q_pos, cfg.rope_theta)
    q = SR.constrain(q, ("data", "q_seq", "heads", None))
    k = apply_rope(_project(xk, wk), positions, cfg.rope_theta)
    v = _project(xv, wv)
    # (B, S, H, hd) -> (B, H, S, hd) views; the kernel writes its output in
    # q's (B, S, H, hd) layout, so the swap back is free
    out = K.flash_attention_diff(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=spec.causal,
                                 window=spec.window, softcap=spec.softcap,
                                 q_offset=r0)
    out = out.transpose(1, 2).reshape(b, q.shape[1], -1)
    if split:
        return row_parallel(out, wo.reshape(-1, wo.shape[-1]))
    return out @ wo.reshape(-1, wo.shape[-1])


def _sharded_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                       spec: AttnSpec, positions: torch.Tensor
                       ) -> torch.Tensor:
    """Self-attention (train/prefill) on a mesh of ranks; x (B, S, D) is
    whole on every rank of the model axis, and so is the output.

    The layout is the reference's constraint on q, ``("data", "q_seq",
    "heads", None)``: its sequence split over ``"model"`` (the ``q_seq``
    override) runs context-parallel, its heads split head-parallel, and
    neither replicated.  Head-parallel ranks project with their own
    blocks of wq and wo (the local heads come out contiguous, as the
    kernel's TMA needs) and of wk, wv where the kv heads split too, else
    with the slice of kv heads their query heads read; the output is a
    partial sum over the ranks.  A kv grouping that no slice serves (each
    rank's query heads reading a ragged run of kv heads) runs
    replicated."""
    tp = SR.TP_AXIS
    mesh = SR.rank_mesh()
    m, n_tp = mesh.coord(tp), mesh.size(tp)
    b, s, _ = x.shape
    h, hk, g = cfg.n_heads, cfg.n_kv_heads, cfg.q_per_kv
    q_spec = SR.logical_spec(("data", "q_seq", "heads", None),
                             (b * SR.batch_split(), s, h,
                              cfg.resolved_head_dim))
    if tp in SR.axis_names(q_spec[1]):               # context-parallel
        n = s // n_tp
        y = _attention_core(cfg, SR.psum_grad(x, tp),
                            _whole(p["wq"], 1, h, True),
                            _whole(p["wk"], 1, hk, True),
                            _whole(p["wv"], 1, hk, True),
                            _whole(p["wo"], 0, h, True), spec, positions,
                            rows=(m * n, n))
        return SR.constrain(y, ("data", None, "embed_act"),
                            src=SR.PartitionSpec(SR.batch_entry(), tp, None))
    if tp in SR.axis_names(q_spec[2]):               # head-parallel
        hl = h // n_tp
        wk, wv = p["wk"], p["wv"]
        if wk.shape[1] == hk:          # kv heads whole: this rank's slice
            if hl % g == 0:
                lo, nk = m * hl // g, hl // g
            elif g % hl == 0:
                lo, nk = m * hl // g, 1
            else:
                lo = None
            if lo is not None:
                wk = SR.psum_grad(wk, tp)[:, lo:lo + nk]
                wv = SR.psum_grad(wv, tp)[:, lo:lo + nk]
        else:
            lo = 0
        if lo is not None:
            return _attention_core(cfg, SR.psum_grad(x, tp), p["wq"], wk,
                                   wv, p["wo"], spec, positions, split=True)
    y = _attention_core(cfg, x, _whole(p["wq"], 1, h, False),
                        _whole(p["wk"], 1, hk, False),
                        _whole(p["wv"], 1, hk, False),
                        _whole(p["wo"], 0, h, False), spec, positions)
    return SR.constrain(y, ("data", None, "embed_act"))


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
    (jax 0.9.0 does not fuse the chain into one f32 rounding).  On a mesh
    of ranks whose model axis splits ``d_ff``: column-parallel, then
    row-parallel with a psum."""
    act = gelu if cfg.mlp_activation == "gelu" else silu
    mesh = SR.rank_mesh()
    split = (mesh is not None and mesh.size(SR.TP_AXIS) > 1
             and p["w_gate"].shape[1] * mesh.size(SR.TP_AXIS) == cfg.d_ff)
    if split:
        x = SR.psum_grad(x, SR.TP_AXIS)
    xg, xu = fan(x, 2, p["w_gate"].dtype)
    h = act(xg @ p["w_gate"]) * (xu @ p["w_up"])
    h = SR.constrain(h, ("data", None, "mlp_act"))
    if split:
        return row_parallel(h, p["w_down"])
    return SR.constrain(h @ p["w_down"], ("data", None, "embed_act"))


# --------------------------------------------------------------------------- #
# logits / loss
# --------------------------------------------------------------------------- #


def vocab_offset(cfg: ModelConfig, table: torch.Tensor) -> Optional[int]:
    """The first vocab row of this rank's block of the embedding table on a
    mesh of ranks whose model axis splits the vocab, else None."""
    mesh = SR.rank_mesh()
    if mesh is None or table.shape[0] == padded_vocab(cfg):
        return None
    return mesh.coord(SR.TP_AXIS) * table.shape[0]


def lm_logits(cfg: ModelConfig, embed_table: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: logits in x's dtype, then f32; padded vocab columns
    masked to -1e30.  With the vocab split over the model axis (a mesh of
    ranks) this rank's columns, masked by their place in the whole
    vocab."""
    off = vocab_offset(cfg, embed_table)
    if off is not None:
        x = SR.psum_grad(x, SR.TP_AXIS)
    logits = (x @ embed_table.to(x.dtype).t()).float()
    if cfg.final_logit_softcap is not None:
        logits = (torch.tanh(logits / cfg.final_logit_softcap)
                  * cfg.final_logit_softcap)
    pv = logits.shape[-1]
    if (off is None and pv != cfg.vocab_size) or \
            (off is not None and padded_vocab(cfg) != cfg.vocab_size):
        col = (off or 0) + torch.arange(pv, device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return SR.constrain(logits, ("data", None, "vocab_act"))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          vocab_offset: Optional[int] = None
                          ) -> torch.Tensor:
    """The mean (over ``mask``) of -log softmax at the labels.  On a mesh
    of ranks the mean is over the global batch (its sums psummed over the
    batch axes); with ``vocab_offset`` (this rank's first column of a
    vocab split over the model axis) the row max, the sum of exponentials
    and the label's logit come from collectives over the model axis."""
    if vocab_offset is None:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.take_along_dim(logp, labels[..., None].long(),
                                  dim=-1)[..., 0]
    else:
        tp, vl = SR.TP_AXIS, logits.shape[-1]
        top = SR.reduce_plain(logits.detach().amax(-1, keepdim=True), tp,
                              dist.ReduceOp.MAX)
        z = logits - top
        lse = torch.log(SR.psum(torch.exp(z).sum(-1), tp))
        lab = labels.long() - vocab_offset
        mine = (lab >= 0) & (lab < vl)
        picked = torch.take_along_dim(z, lab.clamp(0, vl - 1)[..., None],
                                      dim=-1)[..., 0]
        ll = SR.psum(torch.where(mine, picked, 0.0), tp) - lse
    if SR.rank_mesh() is None:
        if mask is None:
            return -torch.mean(ll)
        mask = mask.float()
        return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    axes = SR.batch_axes()
    if mask is None:
        mask = torch.ones_like(ll)
    mask = mask.float()
    num = SR.psum(torch.sum(ll * mask), axes)
    den = SR.reduce_plain(torch.sum(mask), axes)
    return -num / torch.clamp(den, min=1.0)

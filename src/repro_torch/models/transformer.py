"""The decoder of the dense, moe, ssm, hybrid and vlm families (the port of
``repro.models.transformer``; the encoder-decoder family, in
``models/encdec.py``, reuses its layers).

Layer stacking keeps the JAX package's param layout: ``prelude`` (explicit
leading layers, e.g. kimi-k2's first dense layer), ``blocks`` (the repeating
pattern period, each leaf stacked on a leading group axis) and ``coda`` (the
remainder, e.g. recurrentgemma's 26 = 8 * 3 + 2 layers).  The JAX package
drives ``blocks`` with ``lax.scan``; here a Python loop indexes the group
axis.  The layout is what makes the flat column order match the
reference's.  The ``hybrid`` family's RG-LRU blocks are in
``models/rglru.py``; the ``vlm`` family (a prefix-LM) puts stub prefix
embeddings in front of the tokens, attended bidirectionally among
themselves (``forward(prefix_embeds=)``).  ``forward(remat=True)`` recomputes
each group of ``blocks`` in the backward pass (``remat_call``), as the JAX
package wraps its scanned ``block_fn`` in ``jax.checkpoint``.

Decoding keeps the JAX package's cache layout (``init_cache``: ``pos``, then
per layer a KV ring with absolute ``k_pos`` or a recurrent (SSM or RG-LRU)
state and conv tail, blocks stacked on the group axis) and updates it in
place: ``decode_step`` writes each layer's new rows into the cache's
tensors and advances ``cache["pos"]``.  ``pos`` is a 0-dim tensor, as in the JAX package, or a
(B,) tensor: then every row has its own position clock (rope, ring slot,
``k_pos`` mask) and MoE layers route each row as a capacity group of its
own, which is what the JAX serving engine gets by vmapping a one-row step.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as S
from repro_torch.tree import tree_map, tree_paths

Params = Dict[str, Any]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec", "audio")


def check_family(arch_id: str, family: str) -> None:
    """Raise unless ``family`` is one of the JAX package's."""
    if family not in FAMILIES:
        raise ValueError(f"{arch_id}: unknown family {family!r}; one of "
                         f"{FAMILIES}")


# --------------------------------------------------------------------------- #
# structure
# --------------------------------------------------------------------------- #


def pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    check_family(cfg.arch_id, cfg.family)
    if cfg.family == "ssm":
        return ("ssm",)
    if cfg.family == "hybrid":
        return tuple(cfg.block_pattern or ("rglru", "rglru", "attn_local"))
    if cfg.attn_pattern == "local_global":
        return ("attn_local", "attn")
    if cfg.attn_pattern == "local":
        return ("attn_local",)
    return ("attn",)


def structure(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_prelude, n_groups, n_coda) layers; prelude covers moe.first_dense."""
    per = len(pattern(cfg))
    n_pre = cfg.moe.first_dense_layers if cfg.moe else 0
    rest = cfg.n_layers - n_pre
    return n_pre, rest // per, rest % per


# --------------------------------------------------------------------------- #
# single-layer init / apply
# --------------------------------------------------------------------------- #


def init_layer(gen: Optional[torch.Generator], cfg: ModelConfig, kind: str,
               layer_idx: int, cross: bool = False) -> Params:
    """One layer's params; ``cross`` adds the enc-dec decoder's
    cross-attention (``xattn``) and its norm (``ln_x``)."""
    dev = L._device(gen)
    p: Params = {"ln1": L.init_rmsnorm(cfg, dev)}
    if kind in ("attn", "attn_local"):
        p["attn"] = L.init_attention(gen, cfg)
    elif kind == "rglru":
        p["rglru"] = RG.init_rglru(gen, cfg)
    elif kind == "ssm":
        p["ssm"] = S.init_ssm(gen, cfg)
    if cross:
        p["ln_x"] = L.init_rmsnorm(cfg, dev)
        p["xattn"] = L.init_attention(gen, cfg)
    has_ffn = cfg.d_ff > 0
    if has_ffn:
        p["ln2"] = L.init_rmsnorm(cfg, dev)
        if cfg.is_moe_layer(layer_idx):
            p["moe"] = M.init_moe(gen, cfg)
        else:
            p["mlp"] = L.init_mlp(gen, cfg)
    if cfg.post_norm:
        p["ln1_post"] = L.init_rmsnorm(cfg, dev)
        if has_ffn:
            p["ln2_post"] = L.init_rmsnorm(cfg, dev)
    return p


def _stacked_axes(ax):
    """``ax`` with a leading ``"stack"`` on every leaf (a scanned group)."""
    return tree_map(lambda t: ("stack",) + t, ax)


def layer_axes(cfg: ModelConfig, kind: str, layer_idx: int,
               cross: bool = False) -> Params:
    """``init_layer``'s logical-axes tree."""
    ax: Params = {"ln1": L.RMSNORM_AXES}
    if kind in ("attn", "attn_local"):
        ax["attn"] = L.attention_axes(cfg)
    elif kind == "rglru":
        ax["rglru"] = RG.rglru_axes(cfg)
    elif kind == "ssm":
        ax["ssm"] = S.ssm_axes(cfg)
    if cross:
        ax["ln_x"] = L.RMSNORM_AXES
        ax["xattn"] = L.attention_axes(cfg)
    has_ffn = cfg.d_ff > 0
    if has_ffn:
        ax["ln2"] = L.RMSNORM_AXES
        if cfg.is_moe_layer(layer_idx):
            ax["moe"] = M.moe_axes(cfg)
        else:
            ax["mlp"] = L.mlp_axes(cfg)
    if cfg.post_norm:
        ax["ln1_post"] = L.RMSNORM_AXES
        if has_ffn:
            ax["ln2_post"] = L.RMSNORM_AXES
    return ax


def _attn_spec(cfg: ModelConfig, kind: str,
               prefix_len: int = 0) -> L.AttnSpec:
    return L.AttnSpec(
        causal=True,
        window=cfg.window_size if kind == "attn_local" else None,
        softcap=cfg.attn_logit_softcap, prefix_len=prefix_len)


def residual_norm(cfg: ModelConfig, x: torch.Tensor, y: torch.Tensor,
                  scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + y rounded to x's dtype, the norm of the sum read in f32): XLA
    fuses the add into the norm's f32 upcast in the JAX package's compiled
    layer (bit for bit in bf16); the residual stream carries the rounded
    sum."""
    xs = x.float() + y.float()
    return xs.to(x.dtype), L.rms_norm(xs, scale, cfg.norm_eps, x.dtype)


def _add(x: torch.Tensor, y: torch.Tensor, hand_on: bool) -> torch.Tensor:
    """x + y: rounded to x's dtype, or with ``hand_on`` the f32 sum."""
    return x.float() + y.float() if hand_on else x + y


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, y: torch.Tensor,
         per_row: bool = False, hand_on: bool = False
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's second half after the mixer's output y: residual, norm,
    MLP or MoE, post-norm, residual.  Returns (x, the MoE aux term, or None
    for a layer without MoE); with ``hand_on`` x is the last residual sum
    in f32, unrounded (see ``apply_layer``).  The norm reads the residual
    sum in f32 (``residual_norm``)."""
    if "mlp" not in p and "moe" not in p:
        return _add(x, y, hand_on), None
    x, h = residual_norm(cfg, x, y, p["ln2"])
    aux = None
    if "moe" in p:
        y, aux = M.moe_ffn(cfg, p["moe"], h, per_row=per_row)
    else:
        y = L.mlp(cfg, p["mlp"], h)
    if cfg.post_norm:
        y = L.rms_norm(y, p["ln2_post"], cfg.norm_eps)
    return _add(x, y, hand_on), aux


def apply_layer(cfg: ModelConfig, p: Params, kind: str, x: torch.Tensor,
                positions: torch.Tensor, prefix_len: int = 0,
                hand_on: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence (train/prefill) layer; its first ``prefix_len``
    positions attend to each other both ways.  Returns (x, moe_aux or
    None).

    Inside one compiled stretch of layers (a scanned group, the prelude,
    the coda) the JAX package's XLA hands a layer's last residual sum to
    the next layer's ``ln1`` in f32, unrounded: the norm's f32 upcast
    swallows the add's rounding, as ``residual_norm`` does for ``ln2``;
    only the residual itself, and a scan's carry, are rounded.  So ``x``
    may come in f32 while ``cfg.dtype`` is bf16: ``ln1`` reads it as it
    is, the residual its rounding; and with ``hand_on`` the layer returns
    its own output that way (``forward`` says where)."""
    dt = L._dtype(cfg)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps, dt)
    x = x.to(dt)
    if kind == "ssm":
        y = S.ssm_forward(cfg, p["ssm"], h)
    elif kind == "rglru":
        y = RG.rglru_forward(cfg, p["rglru"], h)
    else:
        y, _ = L.multihead_attention(cfg, p["attn"], h,
                                     _attn_spec(cfg, kind, prefix_len),
                                     positions)
    if cfg.post_norm:
        y = L.rms_norm(y, p["ln1_post"], cfg.norm_eps)
    return _ffn(cfg, p, x, y, hand_on=hand_on)


def decode_layer(cfg: ModelConfig, p: Params, kind: str, cache: Params,
                 x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One-token decode of x (B, 1, D) at ``pos`` (0-dim, or (B,) for a
    clock per row); the layer's cache is updated in place."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        y, _ = S.ssm_decode_step(cfg, p["ssm"], cache, h)
    elif kind == "rglru":
        y, _ = RG.rglru_decode_step(cfg, p["rglru"], cache, h)
    else:
        y = _ring_attention_step(cfg, p["attn"], h, cache, pos,
                                 _attn_spec(cfg, kind))
    if cfg.post_norm:
        y = L.rms_norm(y, p["ln1_post"], cfg.norm_eps)
    x, _ = _ffn(cfg, p, x, y, per_row=pos.dim() == 1)
    return x


def _ring_attention_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                         cache: Params, pos: torch.Tensor,
                         spec: L.AttnSpec) -> torch.Tensor:
    """Decode attention against a (possibly ring-buffered) KV cache.

    cache: {k (B, W, K, hd), v, k_pos (B, W) int32 (absolute; -1 = empty)},
    written in place at slot ``pos % W`` of each row: W == max_len for
    full-attention layers, the window for local ones."""
    b = x.shape[0]
    w = cache["k"].shape[1]
    posb = (pos.expand(b) if pos.dim() == 0 else pos).to(torch.int32)
    positions = posb[:, None]
    q = L.apply_rope(L._project(x, p["wq"]), positions, cfg.rope_theta)
    k_new = L.apply_rope(L._project(x, p["wk"]), positions, cfg.rope_theta)
    v_new = L._project(x, p["wv"])
    rows = torch.arange(b, device=x.device)
    slot = (posb % w).long()
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["k_pos"][rows, slot] = posb
    k_pos = cache["k_pos"]
    mask = (k_pos >= 0) & (k_pos <= positions)
    if spec.window is not None:
        mask = mask & ((positions - k_pos) < spec.window)
    return L.cached_attention(cfg, p["wo"], q, cache["k"], cache["v"],
                              mask[:, None, None, None, :], spec.softcap)


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype: torch.dtype, device=None) -> Params:
    if kind in ("attn", "attn_local"):
        w = min(cfg.window_size, max_len) if kind == "attn_local" else max_len
        shape = (batch, w, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "k_pos": torch.full((batch, w), -1, dtype=torch.int32,
                                    device=device)}
    if kind == "rglru":
        return RG.init_rglru_cache(cfg, batch, dtype, device)
    return S.init_ssm_cache(cfg, batch, dtype, device)


# --------------------------------------------------------------------------- #
# whole-model init
# --------------------------------------------------------------------------- #


def init_stacked(init_one, n: int) -> Optional[Params]:
    """``n`` draws of ``init_one()`` stacked on a leading axis (None for
    none).  Each stacked leaf is allocated once and every draw, in order,
    is copied into its slice: the peak holds the stack and one draw, not
    two stacks."""
    if n == 0:
        return None
    one = init_one()
    stack = tree_map(lambda leaf: leaf.new_empty((n,) + tuple(leaf.shape)),
                     one)
    dsts = [leaf for _, leaf in tree_paths(stack)]
    for i in range(n):
        if one is None:
            one = init_one()
        for dst, (_, src) in zip(dsts, tree_paths(one)):
            dst[i].copy_(src)
        one = None                       # freed before the next draw
    return stack


def init_decoder(gen: Optional[torch.Generator], cfg: ModelConfig
                 ) -> Params:
    """One replica's params, drawn from ``gen`` on its device (``None``:
    on the ``meta`` device); ``blocks`` drawn group by group
    (``init_stacked``)."""
    n_pre, n_grp, n_coda = structure(cfg)
    per = pattern(cfg)
    p: Params = {"embed": L.init_embedding(gen, cfg)}
    p["prelude"] = [init_layer(gen, cfg, cfg.layer_kind(i), i)
                    for i in range(n_pre)]
    p["blocks"] = init_stacked(
        lambda: {f"p{j}": init_layer(gen, cfg, kind, n_pre + j)
                 for j, kind in enumerate(per)}, n_grp)
    base = n_pre + n_grp * len(per)
    p["coda"] = [init_layer(gen, cfg, cfg.layer_kind(base + j), base + j)
                 for j in range(n_coda)]
    p["final_norm"] = L.init_rmsnorm(cfg, L._device(gen))
    return p


def decoder_axes(cfg: ModelConfig) -> Params:
    """``init_decoder``'s logical-axes tree: each ``blocks`` leaf's axes
    behind a leading ``"stack"`` (the group axis; None without groups)."""
    n_pre, n_grp, n_coda = structure(cfg)
    per = pattern(cfg)
    base = n_pre + n_grp * len(per)
    return {"embed": L.embedding_axes(cfg),
            "prelude": [layer_axes(cfg, cfg.layer_kind(i), i)
                        for i in range(n_pre)],
            "blocks": _stacked_axes(
                {f"p{j}": layer_axes(cfg, kind, n_pre + j)
                 for j, kind in enumerate(per)}) if n_grp else None,
            "coda": [layer_axes(cfg, cfg.layer_kind(base + j), base + j)
                     for j in range(n_coda)],
            "final_norm": L.RMSNORM_AXES}


# --------------------------------------------------------------------------- #
# forward (train / prefill)
# --------------------------------------------------------------------------- #


def _embed(cfg: ModelConfig, table: torch.Tensor,
           tokens: torch.Tensor) -> torch.Tensor:
    x = table[tokens.long()].to(L._dtype(cfg))
    # the scale is rounded to the activation dtype first, as jnp.asarray
    # does; a 0-dim CPU tensor multiplies as a scalar (no host-to-card copy)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)


def _group_views(tree, n_grp: int):
    """The ``n_grp`` per-group views of a stacked tree (one unbind per
    leaf: its backward is one stack, where a select per group would
    zero-fill and add a whole stacked leaf each)."""
    if tree is None or n_grp == 0:
        return []
    unbound = tree_map(lambda leaf: leaf.unbind(0), tree)
    return [tree_map(lambda views: views[g], unbound) for g in range(n_grp)]


def _layers(cfg: ModelConfig, tree) -> List[Tuple[Params, str]]:
    """(layer subtree, layer kind) in depth order, of the params or of a
    decode cache (they share the prelude/blocks/coda layout; the blocks
    come as per-group views)."""
    n_pre, n_grp, _ = structure(cfg)
    per = pattern(cfg)
    out = [(lp, cfg.layer_kind(i))
           for i, lp in enumerate(tree.get("prelude") or [])]
    for gp in _group_views(tree.get("blocks"), n_grp):
        out += [(gp[f"p{j}"], kind) for j, kind in enumerate(per)]
    base = n_pre + n_grp * len(per)
    out += [(lp, cfg.layer_kind(base + j))
            for j, lp in enumerate(tree.get("coda") or [])]
    return out


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat``, under non-reentrant activation
    checkpointing: autograd records the same graph, but the tensors ``fn``
    saves are dropped and recomputed by running ``fn`` again when the
    backward pass first needs them (so the kernels in ``fn`` launch twice,
    and the gradients are the same bits).  No forward of the zoo draws
    random numbers, so the RNG state is not stashed for the recompute
    (``preserve_rng_state=False``: no get and set of the CPU and CUDA
    generators per call)."""
    if not remat:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) [+ prefix embeddings (B, P, D), the vlm family's stub
    frontend] -> (logits (B, P + S, V_pad) f32, moe_aux f32).

    The ``sqrt(d_model)`` scale applies to the token embeddings only; the
    prefix is cast to the activation dtype and goes in front, unscaled,
    and its P positions attend to each other both ways.  Empty
    ``prelude``/``coda`` lists and a missing ``blocks`` may be absent from
    ``params`` (a tree rebuilt from a flat row drops empty subtrees).
    ``remat`` checkpoints each group of ``blocks`` (its ``pattern(cfg)``
    layers, carrying x and the aux sum); the prelude and coda layers are
    not checkpointed, as in the JAX package."""
    table = params["embed"]["table"]
    x = _embed(cfg, table, tokens)
    prefix_len = 0
    if prefix_embeds is not None:
        prefix_len = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None, :].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(layers, x, aux, round_last):
        for i, (lp, kind) in enumerate(layers):
            x, a = apply_layer(cfg, lp, kind, x, positions, prefix_len,
                               hand_on=i + 1 < len(layers) or not round_last)
            if a is not None:
                aux = aux + a
        return x, aux

    # a layer rounds its output only where the JAX package's scan carries
    # it (the prelude's last layer before the groups, each group's last);
    # every other layer hands its f32 sum on (``apply_layer``), the last
    # coda layer to the final norm
    n_pre, n_grp, _ = structure(cfg)
    per = len(pattern(cfg))
    layers = _layers(cfg, params)
    x, aux = run(layers[:n_pre], x, aux, round_last=n_grp > 0)
    for g in range(n_grp):
        lo = n_pre + g * per
        x, aux = remat_call(remat, run, layers[lo:lo + per], x, aux, True)
    x, aux = run(layers[n_pre + n_grp * per:], x, aux, round_last=False)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps, L._dtype(cfg))
    return L.lm_logits(cfg, table, x), aux


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Params:
    """Decode cache (local-attention layers get ring buffers of the window;
    ``pos`` a 0-dim int32 tensor)."""
    dtype = L._dtype(cfg)
    n_pre, n_grp, n_coda = structure(cfg)
    per = pattern(cfg)
    cache: Params = {"pos": torch.zeros((), dtype=torch.int32,
                                        device=device)}
    cache["prelude"] = [_layer_cache(cfg, cfg.layer_kind(i), batch, max_len,
                                     dtype, device) for i in range(n_pre)]
    if n_grp > 0:
        one = {f"p{j}": _layer_cache(cfg, kind, batch, max_len, dtype,
                                     device) for j, kind in enumerate(per)}
        cache["blocks"] = tree_map(
            lambda t: t[None].expand((n_grp,) + tuple(t.shape)).clone(), one)
    else:
        cache["blocks"] = None
    base = n_pre + n_grp * len(per)
    cache["coda"] = [_layer_cache(cfg, cfg.layer_kind(base + j), batch,
                                  max_len, dtype, device)
                     for j in range(n_coda)]
    return cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """token (B, 1) int -> (logits (B, 1, V_pad) f32, cache), the cache
    updated in place and ``cache["pos"]`` advanced by one."""
    if token.dim() != 2 or token.shape[1] != 1:
        raise ValueError(f"decode_step: token must be (B, 1), got "
                         f"{tuple(token.shape)}")
    pos = cache["pos"]
    table = params["embed"]["table"]
    x = _embed(cfg, table, token)
    for (lp, kind), (lc, _) in zip(_layers(cfg, params),
                                   _layers(cfg, cache)):
        x = decode_layer(cfg, lp, kind, lc, x, pos)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["pos"] = pos + 1
    return L.lm_logits(cfg, table, x), cache


def prefill_cache(cfg: ModelConfig, params: Params, cache: Params,
                  tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """Decode the prompt tokens (B, S0) into the cache one step at a time
    (the reference path) -> (logits (B, S0, V_pad), cache)."""
    logits = []
    for i in range(tokens.shape[1]):
        step, cache = decode_step(cfg, params, cache, tokens[:, i:i + 1])
        logits.append(step[:, 0])
    return torch.stack(logits, dim=1), cache

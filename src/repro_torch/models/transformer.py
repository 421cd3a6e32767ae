"""The decoder of the dense, moe and ssm families (the port of
``repro.models.transformer``).

Layer stacking keeps the JAX package's param layout: ``prelude`` (explicit
leading layers, e.g. kimi-k2's first dense layer), ``blocks`` (the repeating
pattern period, each leaf stacked on a leading group axis) and ``coda`` (the
remainder).  The JAX package drives ``blocks`` with ``lax.scan``; here a
Python loop indexes the group axis.  The layout is what makes the flat
column order match the reference's.  The ``dense``, ``moe`` and ``ssm``
families are ported; the other families raise ``NotImplementedError``
naming their ROADMAP item.

Decoding keeps the JAX package's cache layout (``init_cache``: ``pos``, then
per layer a KV ring with absolute ``k_pos`` or an SSM state and conv tail,
blocks stacked on the group axis) and updates it in place: ``decode_step``
writes each layer's new rows into the cache's tensors and advances
``cache["pos"]``.  ``pos`` is a 0-dim tensor, as in the JAX package, or a
(B,) tensor: then every row has its own position clock (rope, ring slot,
``k_pos`` mask) and MoE layers route each row as a capacity group of its
own, which is what the JAX serving engine gets by vmapping a one-row step.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.tree import tree_map, tree_paths

Params = Dict[str, Any]

_PORTED_FAMILIES = ("dense", "moe", "ssm")
_UNPORTED_FAMILIES = {
    "hybrid": "ROADMAP Queue A item 6: the hybrid family (recurrentgemma, "
              "models/rglru.py)",
    "vlm": "ROADMAP Queue A item 6: the vlm family (paligemma)",
    "encdec": "ROADMAP Queue A item 6: the encdec/audio family",
    "audio": "ROADMAP Queue A item 6: the encdec/audio family",
}


def check_family(arch_id: str, family: str) -> None:
    """Raise unless ``family`` is one the port runs (dense, moe, ssm)."""
    if family not in _PORTED_FAMILIES:
        why = _UNPORTED_FAMILIES.get(family, "ROADMAP Queue A item 6")
        raise NotImplementedError(
            f"{arch_id}: the {family!r} family is not ported to PyTorch "
            f"yet — {why}")


# --------------------------------------------------------------------------- #
# structure
# --------------------------------------------------------------------------- #


def pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    check_family(cfg.arch_id, cfg.family)
    if cfg.family == "ssm":
        return ("ssm",)
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
               layer_idx: int) -> Params:
    dev = L._device(gen)
    p: Params = {"ln1": L.init_rmsnorm(cfg, dev)}
    if kind in ("attn", "attn_local"):
        p["attn"] = L.init_attention(gen, cfg)
    elif kind == "ssm":
        p["ssm"] = S.init_ssm(gen, cfg)
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


def _attn_spec(cfg: ModelConfig, kind: str) -> L.AttnSpec:
    return L.AttnSpec(
        causal=True,
        window=cfg.window_size if kind == "attn_local" else None,
        softcap=cfg.attn_logit_softcap)


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, y: torch.Tensor,
         per_row: bool = False
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's second half after the mixer's output y: residual, norm,
    MLP or MoE, post-norm, residual.  Returns (x, the MoE aux term, or None
    for a layer without MoE).

    The norm reads the residual sum x + y in f32, before it is rounded to
    the activation dtype: XLA fuses the add into the norm's f32 upcast in
    the JAX package's compiled layer (bit for bit in bf16); the residual
    stream itself carries the rounded sum."""
    if "mlp" not in p and "moe" not in p:
        return x + y, None
    xs = x.float() + y.float()
    x = xs.to(x.dtype)
    h = L.rms_norm(xs, p["ln2"], cfg.norm_eps, x.dtype)
    aux = None
    if "moe" in p:
        y, aux = M.moe_ffn(cfg, p["moe"], h, per_row=per_row)
    else:
        y = L.mlp(cfg, p["mlp"], h)
    if cfg.post_norm:
        y = L.rms_norm(y, p["ln2_post"], cfg.norm_eps)
    return x + y, aux


def apply_layer(cfg: ModelConfig, p: Params, kind: str, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence (train/prefill) layer.  Returns (x, moe_aux or None)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        y = S.ssm_forward(cfg, p["ssm"], h)
    else:
        y, _ = L.multihead_attention(cfg, p["attn"], h,
                                     _attn_spec(cfg, kind), positions)
    if cfg.post_norm:
        y = L.rms_norm(y, p["ln1_post"], cfg.norm_eps)
    return _ffn(cfg, p, x, y)


def decode_layer(cfg: ModelConfig, p: Params, kind: str, cache: Params,
                 x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One-token decode of x (B, 1, D) at ``pos`` (0-dim, or (B,) for a
    clock per row); the layer's cache is updated in place."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        y, _ = S.ssm_decode_step(cfg, p["ssm"], cache, h)
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
    return S.init_ssm_cache(cfg, batch, dtype, device)


# --------------------------------------------------------------------------- #
# whole-model init
# --------------------------------------------------------------------------- #


def init_decoder(gen: Optional[torch.Generator], cfg: ModelConfig
                 ) -> Params:
    """One replica's params, drawn from ``gen`` on its device (``None``:
    on the ``meta`` device).  Each stacked ``blocks`` leaf is allocated
    once and every group is drawn, in group order, then copied into its
    slice: the peak holds the stack and one group, not two stacks."""
    n_pre, n_grp, n_coda = structure(cfg)
    per = pattern(cfg)
    p: Params = {"embed": L.init_embedding(gen, cfg)}
    p["prelude"] = [init_layer(gen, cfg, cfg.layer_kind(i), i)
                    for i in range(n_pre)]

    def init_group():
        return {f"p{j}": init_layer(gen, cfg, kind, n_pre + j)
                for j, kind in enumerate(per)}

    if n_grp > 0:
        group = init_group()
        p["blocks"] = tree_map(
            lambda leaf: leaf.new_empty((n_grp,) + tuple(leaf.shape)), group)
        stacked = [leaf for _, leaf in tree_paths(p["blocks"])]
        for g in range(n_grp):
            if group is None:
                group = init_group()
            for dst, (_, src) in zip(stacked, tree_paths(group)):
                dst[g].copy_(src)
            group = None                 # freed before the next draw
    else:
        p["blocks"] = None
    base = n_pre + n_grp * len(per)
    p["coda"] = [init_layer(gen, cfg, cfg.layer_kind(base + j), base + j)
                 for j in range(n_coda)]
    p["final_norm"] = L.init_rmsnorm(cfg, L._device(gen))
    return p


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


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V_pad) f32, moe_aux f32).

    Empty ``prelude``/``coda`` lists and a missing ``blocks`` may be absent
    from ``params`` (a tree rebuilt from a flat row drops empty subtrees)."""
    if prefix_embeds is not None:
        raise NotImplementedError(
            "forward: prefix embeddings are not ported to PyTorch yet — "
            "ROADMAP Queue A item 6 (the vlm family)")
    table = params["embed"]["table"]
    x = _embed(cfg, table, tokens)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None, :].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in _layers(cfg, params):
        x, a = apply_layer(cfg, lp, kind, x, positions)
        if a is not None:
            aux = aux + a

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
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

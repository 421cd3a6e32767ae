"""The decoder of the dense and ssm families (the port of
``repro.models.transformer``).

Layer stacking keeps the JAX package's param layout: ``prelude`` (explicit
leading layers), ``blocks`` (the repeating pattern period, each leaf stacked
on a leading group axis) and ``coda`` (the remainder).  The JAX package
drives ``blocks`` with ``lax.scan``; here a Python loop indexes the group
axis.  The layout is what makes the flat column order match the
reference's.  The ``dense`` and ``ssm`` families are ported; the other
families raise ``NotImplementedError`` naming their ROADMAP item.  Decoding
is not ported (ROADMAP Queue A item 7, serving).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.tree import tree_map

Params = Dict[str, Any]

_PORTED_FAMILIES = ("dense", "ssm")
_UNPORTED_FAMILIES = {
    "moe": "ROADMAP Queue A item 6: the moe family, with kernel Queue B "
           "item 2 (moe_router)",
    "hybrid": "ROADMAP Queue A item 6: the hybrid family (recurrentgemma, "
              "models/rglru.py)",
    "vlm": "ROADMAP Queue A item 6: the vlm family (paligemma)",
    "encdec": "ROADMAP Queue A item 6: the encdec/audio family",
    "audio": "ROADMAP Queue A item 6: the encdec/audio family",
}


def check_family(arch_id: str, family: str) -> None:
    """Raise unless ``family`` is one the port runs (dense, ssm)."""
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


def init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    p: Params = {"ln1": L.init_rmsnorm(cfg)}
    if kind in ("attn", "attn_local"):
        p["attn"] = L.init_attention(gen, cfg)
    elif kind == "ssm":
        p["ssm"] = S.init_ssm(gen, cfg)
    has_ffn = cfg.d_ff > 0
    if has_ffn:
        p["ln2"] = L.init_rmsnorm(cfg)
        p["mlp"] = L.init_mlp(gen, cfg)
    if cfg.post_norm:
        p["ln1_post"] = L.init_rmsnorm(cfg)
        if has_ffn:
            p["ln2_post"] = L.init_rmsnorm(cfg)
    return p


def _attn_spec(cfg: ModelConfig, kind: str) -> L.AttnSpec:
    return L.AttnSpec(
        causal=True,
        window=cfg.window_size if kind == "attn_local" else None,
        softcap=cfg.attn_logit_softcap)


def apply_layer(cfg: ModelConfig, p: Params, kind: str, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence (train/prefill) layer."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        y = S.ssm_forward(cfg, p["ssm"], h)
    else:
        y = L.multihead_attention(cfg, p["attn"], h, _attn_spec(cfg, kind),
                                  positions)
    if cfg.post_norm:
        y = L.rms_norm(y, p["ln1_post"], cfg.norm_eps)
    x = x + y
    if "mlp" in p:
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        y = L.mlp(cfg, p["mlp"], h)
        if cfg.post_norm:
            y = L.rms_norm(y, p["ln2_post"], cfg.norm_eps)
        x = x + y
    return x


# --------------------------------------------------------------------------- #
# whole-model init
# --------------------------------------------------------------------------- #


def init_decoder(gen: torch.Generator, cfg: ModelConfig) -> Params:
    n_pre, n_grp, n_coda = structure(cfg)
    per = pattern(cfg)
    p: Params = {"embed": L.init_embedding(gen, cfg)}
    p["prelude"] = [init_layer(gen, cfg, cfg.layer_kind(i))
                    for i in range(n_pre)]
    if n_grp > 0:
        groups = [{f"p{j}": init_layer(gen, cfg, kind)
                   for j, kind in enumerate(per)} for _ in range(n_grp)]
        p["blocks"] = tree_map(lambda *ls: torch.stack(ls), *groups)
    else:
        p["blocks"] = None
    base = n_pre + n_grp * len(per)
    p["coda"] = [init_layer(gen, cfg, cfg.layer_kind(base + j))
                 for j in range(n_coda)]
    p["final_norm"] = L.init_rmsnorm(cfg)
    return p


# --------------------------------------------------------------------------- #
# forward (train / prefill)
# --------------------------------------------------------------------------- #


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V_pad) f32.

    Empty ``prelude``/``coda`` lists and a missing ``blocks`` may be absent
    from ``params`` (a tree rebuilt from a flat row drops empty subtrees)."""
    if prefix_embeds is not None:
        raise NotImplementedError(
            "forward: prefix embeddings are not ported to PyTorch yet — "
            "ROADMAP Queue A item 6 (the vlm family)")
    n_pre, n_grp, n_coda = structure(cfg)
    per = pattern(cfg)
    table = params["embed"]["table"]
    x = table[tokens.long()].to(L._dtype(cfg))
    # the scale is rounded to the activation dtype first, as jnp.asarray
    # does; a 0-dim CPU tensor multiplies as a scalar (no host-to-card copy)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None, :].expand(b, s)

    for i, lp in enumerate(params.get("prelude") or []):
        x = apply_layer(cfg, lp, cfg.layer_kind(i), x, positions)
    # one unbind per stacked leaf: its backward is one stack, where a
    # select per group would zero-fill and add a whole stacked leaf each
    groups = tree_map(lambda leaf: leaf.unbind(0), params.get("blocks"))
    for g in range(n_grp):
        gp = tree_map(lambda views: views[g], groups)
        for j, kind in enumerate(per):
            x = apply_layer(cfg, gp[f"p{j}"], kind, x, positions)
    base = n_pre + n_grp * len(per)
    for j, lp in enumerate(params.get("coda") or []):
        x = apply_layer(cfg, lp, cfg.layer_kind(base + j), x, positions)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.lm_logits(cfg, table, x)


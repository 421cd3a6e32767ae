"""The encoder-decoder backbone (the port of ``repro.models.encdec``):
seamless-m4t's text decoder over a speech encoder whose frontend is a stub.

The modality frontend (mel spectrogram and conv feature extractor) is a
stub, as in the JAX package: callers hand in precomputed frame embeddings
(B, F, D).  The encoder is a bidirectional transformer over those frames
(its self-attention through the flash kernel with ``causal=False``); the
decoder a causal one (flash, ``causal=True``) with cross-attention onto the
encoder's output (plain attention, no rope, no mask, as in the JAX
package).

The param tree keeps the JAX package's layout: ``embed``, ``encoder`` and
``decoder`` (each leaf stacked on a leading layer axis; decoder layers add
``ln_x`` and ``xattn``), ``enc_norm`` and ``final_norm``; so does the
decode cache (``pos``, the self-attention ``k``/``v``/``k_pos`` ring and
the ``cross`` keys and values, all stacked on the layer axis), so
``flat_state.params_from_reference`` and ``cache_from_reference`` carry
either across.  ``decode_step`` updates the cache in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]

AUDIO_FRAME_RATIO = 4  # frames = seq_len // 4 (stub frontend downsampling)


def init_encdec(gen: Optional[torch.Generator], cfg: ModelConfig) -> Params:
    """One model's params, drawn from ``gen`` on its device (``None``: on
    the ``meta`` device)."""
    dev = L._device(gen)
    return {"embed": L.init_embedding(gen, cfg),
            "encoder": T.init_stacked(
                lambda: T.init_layer(gen, cfg, "attn", 0), cfg.n_enc_layers),
            "decoder": T.init_stacked(
                lambda: T.init_layer(gen, cfg, "attn", 0, cross=True),
                cfg.n_layers),
            "enc_norm": L.init_rmsnorm(cfg, dev),
            "final_norm": L.init_rmsnorm(cfg, dev)}


def encdec_axes(cfg: ModelConfig) -> Params:
    """``init_encdec``'s logical-axes tree (the layer stacks behind a
    leading ``"stack"``)."""
    return {"embed": L.embedding_axes(cfg),
            "encoder": T._stacked_axes(T.layer_axes(cfg, "attn", 0)),
            "decoder": T._stacked_axes(T.layer_axes(cfg, "attn", 0,
                                                    cross=True)),
            "enc_norm": L.RMSNORM_AXES, "final_norm": L.RMSNORM_AXES}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(
        b, s)


def _encoder_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, _ = L.multihead_attention(cfg, lp["attn"], h, L.AttnSpec(causal=False),
                                 positions)
    return T._ffn(cfg, lp, x, y)[0]


def _decoder_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                   positions: torch.Tensor, enc: torch.Tensor
                   ) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, _ = L.multihead_attention(cfg, lp["attn"], h, L.AttnSpec(causal=True),
                                 positions)
    x, h = T.residual_norm(cfg, x, y, lp["ln_x"])
    y, _ = L.multihead_attention(cfg, lp["xattn"], h,
                                 L.AttnSpec(causal=False), positions,
                                 kv_x=enc)
    return T._ffn(cfg, lp, x, y)[0]


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """frames (B, F, D) stub embeddings -> encoder output (B, F, D);
    ``remat`` checkpoints each layer (``transformer.remat_call``), as the
    JAX package does."""
    b, f, _ = frames.shape
    x = frames.to(L._dtype(cfg))
    positions = _positions(b, f, x.device)
    for lp in T._group_views(params["encoder"], cfg.n_enc_layers):
        x = T.remat_call(remat, _encoder_layer, cfg, lp, x, positions)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            frames: torch.Tensor, remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) target text; frames (B, F, D) stub audio embeddings ->
    (logits (B, S, V_pad) f32, a zero aux term); ``remat`` checkpoints each
    encoder and decoder layer."""
    enc = encode(cfg, params, frames, remat=remat)
    b, s = tokens.shape
    table = params["embed"]["table"]
    x = T._embed(cfg, table, tokens)
    positions = _positions(b, s, x.device)
    for lp in T._group_views(params["decoder"], cfg.n_layers):
        x = T.remat_call(remat, _decoder_layer, cfg, lp, x, positions, enc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (L.lm_logits(cfg, table, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #


def init_cache(cfg: ModelConfig, batch: int, max_len: int, n_frames: int,
               device=None) -> Params:
    """Self-attention KV rings and cross-attention (encoder) keys and
    values for every decoder layer, stacked on the layer axis."""
    dtype = L._dtype(cfg)
    hd = cfg.resolved_head_dim
    n = cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "self": {"k": zeros(n, batch, max_len, cfg.n_kv_heads, hd),
                 "v": zeros(n, batch, max_len, cfg.n_kv_heads, hd),
                 "k_pos": torch.full((n, batch, max_len), -1,
                                     dtype=torch.int32, device=device)},
        "cross": {"k": zeros(n, batch, n_frames, cfg.n_kv_heads, hd),
                  "v": zeros(n, batch, n_frames, cfg.n_kv_heads, hd)},
    }


def fill_cross_cache(cfg: ModelConfig, params: Params, cache: Params,
                     frames: torch.Tensor) -> Params:
    """Run the encoder once and write each decoder layer's cross-attention
    keys and values into the cache (in place); returns the cache."""
    enc = encode(cfg, params, frames)
    dtype = L._dtype(cfg)
    for i, lp in enumerate(T._group_views(params["decoder"], cfg.n_layers)):
        cache["cross"]["k"][i] = L._project(enc, lp["xattn"]["wk"]).to(dtype)
        cache["cross"]["v"][i] = L._project(enc, lp["xattn"]["wv"]).to(dtype)
    return cache


def _cross_attn(cfg: ModelConfig, lp: Params, h: torch.Tensor,
                ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """Cross-attention of ``ln_x``'s output h (B, 1, D) onto the cached
    encoder keys and values (every frame attended)."""
    (hq,) = L.fan(h, 1, lp["xattn"]["wq"].dtype)
    q = L._project(hq, lp["xattn"]["wq"])
    return L.cached_attention(cfg, lp["xattn"]["wo"], q, ck, cv, None, None)


def decode_layer(cfg: ModelConfig, lp: Params, layer: Params,
                 ck: torch.Tensor, cv: torch.Tensor, x: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """One decoder layer's step on x (B, 1, D): self-attention against its
    KV ring ``layer`` (written in place), cross-attention onto the cached
    encoder keys and values, the MLP.  Every layer's output is a carry of
    the reference's scan, rounded; inside, ``ln_x`` and ``ln2`` read the
    residual sums in f32, as in ``_decoder_layer``."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y = T._ring_attention_step(cfg, lp["attn"], h, layer, pos,
                               L.AttnSpec(causal=True))
    # ``ln_x`` and ``ln2`` read their residual sums in f32, as XLA fuses
    # the adds into them (``transformer.residual_norm``)
    x, h = T.residual_norm(cfg, x, y, lp["ln_x"])
    return T._ffn(cfg, lp, x, _cross_attn(cfg, lp, h, ck, cv))[0]


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """token (B, 1) -> (logits (B, 1, V_pad) f32, cache), the self cache
    written in place and ``cache["pos"]`` advanced by one.  The cross keys
    and values must be filled (``fill_cross_cache``)."""
    if token.dim() != 2 or token.shape[1] != 1:
        raise ValueError(f"decode_step: token must be (B, 1), got "
                         f"{tuple(token.shape)}")
    pos = cache["pos"]
    table = params["embed"]["table"]
    x = T._embed(cfg, table, token)
    sc, cc = cache["self"], cache["cross"]
    for i, lp in enumerate(T._group_views(params["decoder"], cfg.n_layers)):
        layer = {"k": sc["k"][i], "v": sc["v"][i], "k_pos": sc["k_pos"][i]}
        x = decode_layer(cfg, lp, layer, cc["k"][i], cc["v"][i], x, pos)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["pos"] = pos + 1
    return L.lm_logits(cfg, table, x), cache

"""Family dispatch: one interface over the architectures the port runs.

The port of ``repro.models.registry``.  The LM fleet talks only to
``init_params``, ``compute_loss`` and ``forward_logits``; serving to
``init_decode_cache`` and ``serve_step``.  Every arch id of the JAX
package resolves: the decoder families through ``models/transformer.py``
(the vlm family with its stub prefix embeddings, ``batch["prefix_embeds"]``)
and the encoder-decoder family through ``models/encdec.py`` (its stub
frames, ``batch["frames"]``).  ``compute_loss`` returns the cross-entropy
plus ``router_aux_weight`` times the MoE load-balance term (0 for a family
without MoE), as the JAX package's does.  The shape helpers
(``batch_specs``, ``abstract_decode_cache``, ``supported_shapes``,
``long_context_capable``) answer without allocating: their tensors live on
the ``meta`` device, as do ``abstract_params``'s.  ``param_axes`` and
``batch_logical_axes`` give the logical-axes trees that
``sharding.rules`` turns into specs (the JAX package's ``init_params``
returns its axes beside the params; here they come from ``cfg`` alone).
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeSpec
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]

ARCH_IDS = [
    "kimi-k2-1t-a32b", "seamless-m4t-medium", "gemma2-2b", "smollm-360m",
    "recurrentgemma-2b", "smollm-135m", "paligemma-3b", "stablelm-1.6b",
    "grok-1-314b", "mamba2-2.7b",
]
DENSE_ARCH_IDS = ("gemma2-2b", "smollm-135m", "smollm-360m", "stablelm-1.6b")


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.family in ("encdec", "audio")


def has_prefix(cfg: ModelConfig) -> bool:
    return cfg.family == "vlm"


def frames_for(cfg: ModelConfig, seq_len: int) -> int:
    """Stub audio frames for ``seq_len`` target tokens."""
    return max(seq_len // E.AUDIO_FRAME_RATIO, 8)


def init_params(cfg: ModelConfig, gen: Optional[torch.Generator]) -> Params:
    """One replica's params, drawn from ``gen`` on the generator's device
    (``None``: shapes and dtypes on the ``meta`` device)."""
    if is_encdec(cfg):
        return E.init_encdec(gen, cfg)
    return T.init_decoder(gen, cfg)


def param_axes(cfg: ModelConfig) -> Params:
    """The logical-axes tree of ``init_params(cfg, ...)``: its structure,
    a tuple of logical axis names per leaf."""
    if is_encdec(cfg):
        return E.encdec_axes(cfg)
    return T.decoder_axes(cfg)


def abstract_params(cfg: ModelConfig) -> Tuple[Params, Params]:
    """(params on the ``meta`` device, their logical axes): shapes and
    dtypes with no allocation."""
    return init_params(cfg, None), param_axes(cfg)


def _logits(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor], remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if is_encdec(cfg):
        return E.forward(cfg, params, batch["tokens"], batch["frames"],
                         remat=remat)
    if has_prefix(cfg):
        return T.forward(cfg, params, batch["tokens"],
                         prefix_embeds=batch["prefix_embeds"], remat=remat)
    return T.forward(cfg, params, batch["tokens"], remat=remat)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec
                ) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of ``shape``: tensors on the
    ``meta`` device (shapes and dtypes, no storage).  Train and prefill
    take tokens, labels and a loss mask, plus the family's stub feed (a
    vlm's text is ``S - n_prefix_tokens`` long behind its prefix
    embeddings; enc-dec takes ``frames_for(cfg, S)`` frames); decode takes
    one token per row."""
    b, s = shape.global_batch, shape.seq_len

    def meta(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.mode not in ("train", "prefill"):
        return {"token": meta((b, 1), torch.int32)}
    dt = L._dtype(cfg)
    if has_prefix(cfg):
        s -= cfg.n_prefix_tokens
    out = {"tokens": meta((b, s), torch.int32),
           "labels": meta((b, s), torch.int32),
           "loss_mask": meta((b, s), torch.float32)}
    if is_encdec(cfg):
        out["frames"] = meta((b, frames_for(cfg, s), cfg.d_model), dt)
    if has_prefix(cfg):
        out["prefix_embeds"] = meta((b, cfg.n_prefix_tokens, cfg.d_model),
                                    dt)
    return out


def batch_logical_axes(cfg: ModelConfig, shape: ShapeSpec
                       ) -> Dict[str, tuple]:
    """Logical axes of ``batch_specs(cfg, shape)``'s inputs."""
    if shape.mode not in ("train", "prefill"):
        return {"token": ("data", None)}
    ax = {"tokens": ("data", None), "labels": ("data", None),
          "loss_mask": ("data", None)}
    if is_encdec(cfg):
        ax["frames"] = ("data", None, "embed_act")
    if has_prefix(cfg):
        ax["prefix_embeds"] = ("data", None, "embed_act")
    return ax


def forward_logits(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Prefill-mode forward (no loss); a vlm's logits keep the prefix's
    positions, as the JAX package's do."""
    return _logits(cfg, params, batch)[0]


def compute_loss(cfg: ModelConfig, params: Params,
                 batch: Dict[str, torch.Tensor], remat: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(ce + router_aux_weight * moe_aux, {"ce", "moe_aux"}); a vlm's
    cross-entropy is over the text positions, past ``n_prefix_tokens``.
    ``remat`` recomputes activations in the backward pass (the same
    values; see ``transformer.forward``)."""
    logits, aux = _logits(cfg, params, batch, remat)
    if has_prefix(cfg):
        logits = logits[:, cfg.n_prefix_tokens:]
    ce = L.softmax_cross_entropy(logits, batch["labels"],
                                 batch.get("loss_mask"))
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    return ce + aux_w * aux, {"ce": ce, "moe_aux": aux}


def init_decode_cache(cfg: ModelConfig, shape: ShapeSpec,
                      device=None) -> Params:
    """The decode cache for ``shape.global_batch`` rows of
    ``shape.seq_len`` positions (enc-dec: plus the cross caches of
    ``frames_for(cfg, seq_len)`` frames)."""
    if is_encdec(cfg):
        return E.init_cache(cfg, shape.global_batch, shape.seq_len,
                            frames_for(cfg, shape.seq_len), device)
    return T.init_cache(cfg, shape.global_batch, shape.seq_len, device)


def abstract_decode_cache(cfg: ModelConfig, shape: ShapeSpec) -> Params:
    """``init_decode_cache`` on the ``meta`` device: the cache's tree,
    shapes and dtypes, no storage."""
    return init_decode_cache(cfg, shape, "meta")


def serve_step(cfg: ModelConfig, params: Params, cache: Params,
               token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """token (B, 1) -> (logits (B, 1, V_pad), cache), the cache updated in
    place (``transformer.decode_step``, ``encdec.decode_step``)."""
    if is_encdec(cfg):
        return E.decode_step(cfg, params, cache, token)
    return T.decode_step(cfg, params, cache, token)


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).get_config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).get_smoke_config()


def long_context_capable(cfg: ModelConfig) -> bool:
    """May this arch run the long_500k shape? (a sub-quadratic path:
    the ssm and hybrid families, or dense attention with a
    sliding-window/local variant)"""
    if cfg.family in ("ssm", "hybrid"):
        return True
    return cfg.attn_pattern in ("local", "local_global")


def supported_shapes(cfg: ModelConfig) -> List[ShapeSpec]:
    """The ``INPUT_SHAPES`` this arch runs, in their order (long_500k only
    where ``long_context_capable``)."""
    return [spec for name, spec in INPUT_SHAPES.items()
            if name != "long_500k" or long_context_capable(cfg)]

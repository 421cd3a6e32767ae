"""Family dispatch: one interface over the architectures the port runs.

The port of ``repro.models.registry``.  The LM fleet talks only to
``init_params``, ``compute_loss`` and ``forward_logits``; serving to
``init_decode_cache`` and ``serve_step``.  Every arch id of the JAX
package resolves: the decoder families through ``models/transformer.py``
(the vlm family with its stub prefix embeddings, ``batch["prefix_embeds"]``)
and the encoder-decoder family through ``models/encdec.py`` (its stub
frames, ``batch["frames"]``).  ``compute_loss`` returns the cross-entropy
plus ``router_aux_weight`` times the MoE load-balance term (0 for a family
without MoE), as the JAX package's does.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
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


def _logits(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if is_encdec(cfg):
        return E.forward(cfg, params, batch["tokens"], batch["frames"])
    if has_prefix(cfg):
        return T.forward(cfg, params, batch["tokens"],
                         prefix_embeds=batch["prefix_embeds"])
    return T.forward(cfg, params, batch["tokens"])


def forward_logits(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Prefill-mode forward (no loss); a vlm's logits keep the prefix's
    positions, as the JAX package's do."""
    return _logits(cfg, params, batch)[0]


def compute_loss(cfg: ModelConfig, params: Params,
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(ce + router_aux_weight * moe_aux, {"ce", "moe_aux"}); a vlm's
    cross-entropy is over the text positions, past ``n_prefix_tokens``."""
    logits, aux = _logits(cfg, params, batch)
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

"""Family dispatch: one interface over the architectures the port runs.

The port of ``repro.models.registry``.  The LM fleet talks only to
``init_params``, ``compute_loss`` and ``forward_logits``; serving to
``init_decode_cache`` and ``serve_step``.  Every arch id of the JAX package
is listed in ``ARCH_IDS``; the dense ones, mamba2-2.7b (ssm), grok-1-314b
and kimi-k2-1t-a32b (moe) resolve, the rest raise ``NotImplementedError``
naming their ROADMAP item.  The moe family serves but does not train yet:
``compute_loss`` raises on it (ROADMAP Queue A item 6: the MoE fleet, with
the router's gradient and the aux loss).
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]

ARCH_IDS = [
    "kimi-k2-1t-a32b", "seamless-m4t-medium", "gemma2-2b", "smollm-360m",
    "recurrentgemma-2b", "smollm-135m", "paligemma-3b", "stablelm-1.6b",
    "grok-1-314b", "mamba2-2.7b",
]
DENSE_ARCH_IDS = ("gemma2-2b", "smollm-135m", "smollm-360m", "stablelm-1.6b")
_FAMILY = {
    "kimi-k2-1t-a32b": "moe", "grok-1-314b": "moe",
    "recurrentgemma-2b": "hybrid", "paligemma-3b": "vlm",
    "seamless-m4t-medium": "audio",
}
_ENCDEC = ("encoder-decoder decoding (cross caches, E_prefill) is not "
           "ported to PyTorch yet — ROADMAP Queue A item 6 (the "
           "encdec/audio family)")


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.family in ("encdec", "audio")


def has_prefix(cfg: ModelConfig) -> bool:
    return cfg.family == "vlm"


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a family the port serves but does not train (moe)."""
    if cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.arch_id}: training the moe family (the router's gradient "
            f"and the aux loss in the LM fleet) is not ported to PyTorch yet "
            f"— ROADMAP Queue A item 6")


def init_params(cfg: ModelConfig, gen: Optional[torch.Generator]) -> Params:
    """One replica's params, drawn from ``gen`` on the generator's device
    (``None``: shapes and dtypes on the ``meta`` device)."""
    return T.init_decoder(gen, cfg)


def forward_logits(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Prefill-mode forward (no loss)."""
    return T.forward(cfg, params, batch["tokens"])[0]


def compute_loss(cfg: ModelConfig, params: Params,
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    check_trainable(cfg)
    logits = forward_logits(cfg, params, batch)
    ce = L.softmax_cross_entropy(logits, batch["labels"],
                                 batch.get("loss_mask"))
    return ce, {"ce": ce}


def init_decode_cache(cfg: ModelConfig, shape: ShapeSpec,
                      device=None) -> Params:
    """The decode cache for ``shape.global_batch`` rows of
    ``shape.seq_len`` positions."""
    if is_encdec(cfg):
        raise NotImplementedError(f"init_decode_cache: {_ENCDEC}")
    return T.init_cache(cfg, shape.global_batch, shape.seq_len, device)


def serve_step(cfg: ModelConfig, params: Params, cache: Params,
               token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """token (B, 1) -> (logits (B, 1, V_pad), cache), the cache updated in
    place (``transformer.decode_step``)."""
    if is_encdec(cfg):
        raise NotImplementedError(f"serve_step: {_ENCDEC}")
    return T.decode_step(cfg, params, cache, token)


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    T.check_family(arch_id, _FAMILY.get(arch_id, "dense"))
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).get_config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).get_smoke_config()

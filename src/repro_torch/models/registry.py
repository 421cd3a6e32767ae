"""Family dispatch: one interface over the architectures the port runs.

The port of ``repro.models.registry``.  The LM fleet talks only to
``init_params``, ``compute_loss`` and ``forward_logits``.  Every arch id of
the JAX package is listed in ``ARCH_IDS``; the dense ones and mamba2-2.7b
(ssm) resolve, the rest raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]

ARCH_IDS = [
    "kimi-k2-1t-a32b", "seamless-m4t-medium", "gemma2-2b", "smollm-360m",
    "recurrentgemma-2b", "smollm-135m", "paligemma-3b", "stablelm-1.6b",
    "grok-1-314b", "mamba2-2.7b",
]
DENSE_ARCH_IDS = ("gemma2-2b", "smollm-135m", "smollm-360m", "stablelm-1.6b")
_UNPORTED = {
    "kimi-k2-1t-a32b": "moe", "grok-1-314b": "moe",
    "recurrentgemma-2b": "hybrid", "paligemma-3b": "vlm",
    "seamless-m4t-medium": "audio",
}


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.family in ("encdec", "audio")


def has_prefix(cfg: ModelConfig) -> bool:
    return cfg.family == "vlm"


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """One replica's params, drawn on the CPU from ``gen``."""
    return T.init_decoder(gen, cfg)


def forward_logits(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Prefill-mode forward (no loss)."""
    return T.forward(cfg, params, batch["tokens"])


def compute_loss(cfg: ModelConfig, params: Params,
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = forward_logits(cfg, params, batch)
    ce = L.softmax_cross_entropy(logits, batch["labels"],
                                 batch.get("loss_mask"))
    return ce, {"ce": ce}


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    T.check_family(arch_id, _UNPORTED.get(arch_id, "dense"))
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).get_config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).get_smoke_config()

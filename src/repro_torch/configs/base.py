"""Config dataclasses shared by every architecture in the zoo.

The port's copy of ``repro.configs.base``: every field of the JAX package's
dataclasses and the properties the models read (its analytic parameter
counts are not ported), so a config names the same model in both
packages.  ``ModelConfig.kernels`` holds the port's ``KernelConfig`` (tile
sizes only: the tensor's device decides whether a kernel or its plain
version runs).  One file per ported architecture lives next to this module
(see ``models/registry.py``); each exports ``get_config()`` (the published
geometry) and ``get_smoke_config()`` (a reduced variant of the same family
for CPU tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.kernels.config import KernelConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                      # per-expert hidden dim
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    first_dense_layers: int = 0        # leading layers that use a dense FFN


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2                    # d_inner = expand * d_model
    chunk_size: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // n_heads
    # --- attention behaviour ---
    attn_pattern: str = "global"       # global | local_global (alternating) | local
    window_size: int = 4096
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    # --- family extras ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    block_pattern: Optional[Sequence[str]] = None   # hybrid: e.g. ("rglru","rglru","attn")
    n_enc_layers: int = 0              # encdec only
    # --- modality frontend stub (vlm/audio): precomputed embeddings prefix ---
    n_prefix_tokens: int = 0
    frontend: Optional[str] = None     # vision | audio | None
    # --- misc ---
    mlp_activation: str = "silu"       # silu (SwiGLU) | gelu (GeGLU)
    attn_impl: str = "naive"           # naive (einsum) | chunked (online softmax)
    attn_chunk: int = 512              # kv block for attn_impl="chunked"
    kernels: KernelConfig = KernelConfig()  # the port's kernel tiles; the
                                       # forward pass always goes through
                                       # the zoo kernels (plain backward)
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    post_norm: bool = False            # gemma2-style extra post-block norms
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def layer_kind(self, layer_idx: int) -> str:
        """What block does layer `layer_idx` run? attn|attn_local|rglru|ssm."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            pat = tuple(self.block_pattern or ("rglru", "rglru", "attn_local"))
            return pat[layer_idx % len(pat)]
        if self.attn_pattern == "local_global":
            return "attn_local" if layer_idx % 2 == 0 else "attn"
        if self.attn_pattern == "local":
            return "attn_local"
        return "attn"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                          # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

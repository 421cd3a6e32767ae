"""Config dataclasses shared by every architecture in the zoo.

The port's copy of ``repro.configs.base``: every field of the JAX package's
dataclasses, the properties the models read and its analytic parameter
counts (``param_count``, ``active_param_count``, copied with their quirks:
they are not a real init's count, and ``launch/analysis.py``'s model
FLOPs must equal the JAX package's), so a config names the same model in
both packages.  ``ModelConfig.kernels`` holds the port's ``KernelConfig`` (tile
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
    attn_impl: str = "naive"           # naive (einsum) | chunked (online
                                       # softmax); read only where flash
                                       # does not run: the prefix-LM's self-
                                       # attention (models/layers.py)
    attn_chunk: int = 512              # kv block for attn_impl="chunked"
    kernels: KernelConfig = KernelConfig()  # the port's kernel tiles; a
                                       # CUDA tensor runs the zoo kernels
                                       # where the reference's Pallas
                                       # backend would (plain backward)
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

    def is_moe_layer(self, layer_idx: int) -> bool:
        return self.moe is not None and layer_idx >= self.moe.first_dense_layers

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

    def param_count(self) -> int:
        """Analytic parameter count (the JAX package's arithmetic verbatim,
        quirks included: an rglru layer counts d * d width and 3 vectors,
        every layer 2 norms; paligemma-3b's real init holds more)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        dense_ffn = 3 * d * self.d_ff
        total = self.vocab_size * d  # embed (tied head)
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind in ("attn", "attn_local"):
                total += attn
            elif kind == "rglru":
                dr = d                                     # rglru width = d_model
                total += 2 * d * dr + dr * d + 3 * dr      # in/gate proj, out proj, recurrent params
            elif kind == "ssm":
                s = self.ssm or SSMConfig()
                din = s.expand * d
                nheads = din // s.head_dim
                total += d * (2 * din + 2 * s.d_state + nheads) + din * d + nheads
            if self.family == "encdec":
                total += attn  # cross-attention in decoder layers
            if self.is_moe_layer(i):
                m = self.moe
                total += d * m.n_experts  # router
                total += m.n_experts * 3 * d * m.d_expert
                total += m.n_shared_experts * 3 * d * m.d_expert
            else:
                total += dense_ffn
            total += 2 * d  # norms
        for _ in range(self.n_enc_layers):
            total += attn + dense_ffn + 2 * d
        total += d  # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full_experts = self.n_layers - m.first_dense_layers
        inactive = full_experts * (m.n_experts - m.top_k) * 3 * self.d_model * m.d_expert
        return int(self.param_count() - inactive)


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

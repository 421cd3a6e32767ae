"""Grok-1 314B [hf:xai-org/grok-1] — 8-expert top-2 MoE.

64L d_model=6144 48H (GQA kv=8) expert d_ff=32768 vocab=131072.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        head_dim=128,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768),
        attn_logit_softcap=30.0,
        final_logit_softcap=30.0,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="grok-1-314b-smoke",
        family="moe",
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=1024,
        head_dim=32,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=256),
        attn_logit_softcap=30.0,
        final_logit_softcap=30.0,
    )

"""Kimi K2 — trillion-param MoE (paper-table geometry) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840, MoE 384 experts
top-8 + 1 shared expert; first layer dense.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=163840,
        head_dim=112,
        moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048,
                      n_shared_experts=1, first_dense_layers=1),
        rope_theta=50000.0,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="kimi-k2-1t-a32b-smoke",
        family="moe",
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=1024,
        head_dim=32,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128,
                      n_shared_experts=1, first_dense_layers=1),
    )

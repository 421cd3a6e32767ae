"""PaliGemma 3B [arXiv:2407.07726] — SigLIP vision encoder (STUB) + gemma
language backbone as a prefix-LM (bidirectional prefix, causal suffix).

18L d_model=2048 8H (MQA kv=1, head_dim=256) d_ff=16384 vocab=257216;
256 image tokens from the stub frontend.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        d_ff=16384,
        vocab_size=257216,
        head_dim=256,
        n_prefix_tokens=256,
        frontend="vision",
        mlp_activation="gelu",
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="paligemma-3b-smoke",
        family="vlm",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=1,
        d_ff=512,
        vocab_size=1024,
        head_dim=64,
        n_prefix_tokens=16,
        frontend="vision",
        mlp_activation="gelu",
    )

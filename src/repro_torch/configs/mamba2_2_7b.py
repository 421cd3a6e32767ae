"""Mamba-2 2.7B [arXiv:2405.21060] — SSD (state-space duality), attention-free.

64L d_model=2560 (d_inner=5120, head_dim=64 -> 80 heads) ssm_state=128
vocab=50280; no FFN (pure stack of SSD blocks).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=1,           # unused (attention-free)
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256),
        tie_embeddings=True,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-2.7b-smoke",
        family="ssm",
        n_layers=2,
        d_model=256,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=1024,
        ssm=SSMConfig(d_state=32, head_dim=32, expand=2, chunk_size=32),
    )

"""Gemma 2 2B [arXiv:2408.00118] — local+global alternating attention,
attention/final logit softcapping, GeGLU, post-norms.

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        d_ff=9216,
        vocab_size=256000,
        head_dim=256,
        attn_pattern="local_global",
        window_size=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        mlp_activation="gelu",
        post_norm=True,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma2-2b-smoke",
        family="dense",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=1024,
        head_dim=64,
        attn_pattern="local_global",
        window_size=64,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        mlp_activation="gelu",
        post_norm=True,
    )

"""SeamlessM4T-medium backbone [arXiv:2308.11596] — enc-dec, multimodal.

12L(enc)+12L(dec) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.  The
speech frontend (mel + conv feature extractor) is a stub; input_specs provides
precomputed frame embeddings (B, seq//4, d_model).
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="seamless-m4t-medium",
        family="audio",
        n_layers=12,
        n_enc_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        frontend="audio",
        mlp_activation="gelu",
        tie_embeddings=True,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="seamless-m4t-medium-smoke",
        family="audio",
        n_layers=2,
        n_enc_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=512,
        vocab_size=1024,
        frontend="audio",
        mlp_activation="gelu",
    )

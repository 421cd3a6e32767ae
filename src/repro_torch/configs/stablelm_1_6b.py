"""StableLM 2 1.6B [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab_size=100352,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="stablelm-1.6b-smoke",
        family="dense",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=512,
        vocab_size=1024,
    )

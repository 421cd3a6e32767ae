"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-135M family] — llama-arch small.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="smollm-360m",
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="smollm-360m-smoke",
        family="dense",
        n_layers=2,
        d_model=240,
        n_heads=3,
        n_kv_heads=1,
        d_ff=512,
        vocab_size=1024,
    )

"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="smollm-135m-smoke",
        family="dense",
        n_layers=2,
        d_model=192,
        n_heads=3,
        n_kv_heads=1,
        d_ff=384,
        vocab_size=1024,
    )

"""RecurrentGemma 2B (Griffin) [arXiv:2402.19427] — RG-LRU + local attention,
pattern 2 recurrent : 1 local-attn.

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000.
26 = 8 full (rglru, rglru, attn_local) periods + 2 coda rglru layers.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        arch_id="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        head_dim=256,
        block_pattern=("rglru", "rglru", "attn_local"),
        window_size=2048,
        mlp_activation="gelu",
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="recurrentgemma-2b-smoke",
        family="hybrid",
        n_layers=3,          # one full (rglru, rglru, attn_local) period
        d_model=256,
        n_heads=4,
        n_kv_heads=1,
        d_ff=512,
        vocab_size=1024,
        head_dim=64,
        block_pattern=("rglru", "rglru", "attn_local"),
        window_size=64,
        mlp_activation="gelu",
    )

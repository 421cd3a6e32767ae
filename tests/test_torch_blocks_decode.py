"""One decode step, block by block against the JAX package as it compiles
it, for every smoke config (the harness is ``tests/_torch_blocks.py``).

The reference prefills a seeded 12-token prompt into its cache
(``transformer.prefill_cache``; seamless: ``encdec.fill_cross_cache`` and
its ``decode_step`` under a scan), the port takes the cache over
(``flat_state.cache_from_reference``), and the next token's step is read
block by block on the reference's own values: each layer (its output and
the cache rows it writes; ``transformer.decode_layer``, seamless's
``encdec.decode_layer``), each layer again as the serving engine's
vmapped one-row step reads it (``drows``: the port with a (B,) position
vector), each mixer's step (``_ring_attention_step``,
``rglru_decode_step``, ``ssm_decode_step``; seamless's self and cross
steps) and the head.  The chain: the reference's jitted layers, chained,
give its own ``decode_step``'s logits bit for bit in every config and
dtype (``test_decode_chain_is_the_model``).

Repaired: the decode step hands a layer's f32 sum on inside a group as
the forward does (``decode_layer(hand_on=)``, ``decode_step``'s
prelude/groups/coda), and seamless's decoder reads its ``ln_x`` and
``ln2`` residual sums in f32 (``encdec.decode_layer``).  Largest share
beyond one bf16 ulp over seeds 5-7, before -> after: gemma2's layers
31.8 % -> 0 (their k and v rows 25.4-30.9 % -> 0), recurrentgemma's
RG-LRU layers 23.6 % -> 0 and attention layers 26.0 % -> 0, seamless's
decoder layers 30.5 % -> 0.  Every decode block now differs in at most
0.2 % of its values and none beyond an ulp, but the f32 states (sum order)
and gemma2's and grok's head (the final softcap's f32 tanh).

``BOUNDS``: as in ``tests/test_torch_blocks_grad.py``.
"""
import pytest

from _torch_blocks import (DTYPES, SEEDS, check_bounds, check_chain,
                           reading_decode)
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCHS = ("smollm-135m", "smollm-360m", "stablelm-1.6b",
         "gemma2-2b", "recurrentgemma-2b", "mamba2-2.7b",
         "paligemma-3b", "seamless-m4t-medium", "grok-1-314b",
         "kimi-k2-1t-a32b")
BOUNDS = {
    "smollm-135m": {
        "bfloat16": {
            "dhead": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
        },
        "float32": {
            "*": ("rel", 6.9e-06, 4.6e-06),
        },
    },
    "smollm-360m": {
        "bfloat16": {
            "dhead": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:v": ("shares", 0.0094, 0.0002, 0.00625, 0.0),
            "drows:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:v": ("shares", 0.0094, 0.0002, 0.00625, 0.0),
            "dstep:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:v": ("shares", 0.0094, 0.0002, 0.00625, 0.0),
        },
        "float32": {
            "*": ("rel", 8.3e-06, 5.47e-06),
        },
    },
    "stablelm-1.6b": {
        "bfloat16": {
            "dhead": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
        },
        "float32": {
            "*": ("rel", 5.4e-06, 3.58e-06),
        },
    },
    "gemma2-2b": {
        "bfloat16": {
            "dhead": ("shares", 0.89, 0.0002, 0.588, 0.0),
            "dlayer:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn_local:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn_local:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn_local:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn_local:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn_local:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn_local:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn_local:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn_local:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn_local:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn_local:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn_local:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn_local:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
        },
        "float32": {
            "*": ("rel", 3.5e-06, 2.28e-06),
        },
    },
    "recurrentgemma-2b": {
        "bfloat16": {
            "dhead": ("shares", 0.00074, 0.0002, 0.000488, 0.0),
            "dlayer:attn_local:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn_local:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn_local:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn_local:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:rglru:conv_tail": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:rglru:h": ("shares", 0.62, 0.0002, 0.412, 0.0),
            "dlayer:rglru:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn_local:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn_local:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn_local:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn_local:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:rglru:conv_tail": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:rglru:h": ("shares", 0.62, 0.0002, 0.412, 0.0),
            "drows:rglru:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn_local:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn_local:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn_local:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn_local:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:rglru:conv_tail": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:rglru:h": ("shares", 0.62, 0.0002, 0.412, 0.0),
            "dstep:rglru:out": ("shares", 0.003, 0.0002, 0.00195, 0.0),
        },
        "float32": {
            "*": ("rel", 6.8e-06, 4.53e-06),
        },
    },
    "mamba2-2.7b": {
        "bfloat16": {
            "dhead": ("shares", 0.00074, 0.0002, 0.000488, 0.0),
            "dlayer:ssm:conv_tail": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:ssm:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:ssm:state": ("shares", 0.49, 0.0002, 0.322, 0.0),
            "drows:ssm:conv_tail": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:ssm:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:ssm:state": ("shares", 0.49, 0.0002, 0.322, 0.0),
            "dstep:ssm:conv_tail": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:ssm:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:ssm:state": ("shares", 0.49, 0.0002, 0.322, 0.0),
        },
        "float32": {
            "*": ("rel", 7.7e-06, 5.07e-06),
        },
    },
    "paligemma-3b": {
        "bfloat16": {
            "dhead": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:out": ("shares", 0.003, 0.0002, 0.00195, 0.0),
            "dlayer:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:out": ("shares", 0.003, 0.0002, 0.00195, 0.0),
            "drows:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
        },
        "float32": {
            "*": ("rel", 5.1e-06, 3.37e-06),
        },
    },
    "seamless-m4t-medium": {
        "bfloat16": {
            "dhead": ("shares", 0.00074, 0.0002, 0.000488, 0.0),
            "dlayer:dec:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:dec:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:dec:out": ("shares", 0.003, 0.0002, 0.00195, 0.0),
            "dlayer:dec:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:cross:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:self:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:self:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:self:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:self:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
        },
        "float32": {
            "*": ("rel", 5.4e-06, 3.57e-06),
        },
    },
    "grok-1-314b": {
        "bfloat16": {
            "dhead": ("shares", 0.88, 0.0002, 0.586, 0.0),
            "dlayer:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:out": ("shares", 0.003, 0.003, 0.00195, 0.00195),
            "dlayer:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:out": ("shares", 0.003, 0.003, 0.00195, 0.00195),
            "drows:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:out": ("shares", 0.003, 0.0002, 0.00195, 0.0),
            "dstep:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
        },
        "float32": {
            "*": ("rel", 5.5e-06, 3.61e-06),
        },
    },
    "kimi-k2-1t-a32b": {
        "bfloat16": {
            "dhead": ("shares", 0.00074, 0.0002, 0.000488, 0.0),
            "dlayer:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dlayer:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "drows:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:k_pos": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:out": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "dstep:attn:v": ("shares", 0.0002, 0.0002, 0.0, 0.0),
        },
        "float32": {
            "*": ("rel", 5.5e-06, 3.66e-06),
        },
    },
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_blocks_hold_to_the_reference(arch, dtype, seed):
    """Every block of one decode step on the reference's own values after
    a prefill from ``seed``, and each layer as the engine's vmapped step:
    bf16 to its kind's bound in ``BOUNDS``, f32 to its ``rel_err`` bound."""
    pytest.importorskip("jax")
    check_bounds(reading_decode(arch, dtype, seed), BOUNDS[arch][dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chain_is_the_model(arch, dtype):
    """The reference's jitted decode layers, chained, give its own
    ``decode_step``'s logits bit for bit, so each block stands for the
    block as the step runs it."""
    pytest.importorskip("jax")
    check_chain(reading_decode(arch, dtype, SEEDS[0]), {})

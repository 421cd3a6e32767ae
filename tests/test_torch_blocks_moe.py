"""The moe family, block by block against the JAX package as it compiles
it (grok-1-314b: 4 experts, top 2, softcaps; kimi-k2-1t-a32b: a dense
prelude layer, then a MoE layer with a shared expert; the harness is
``tests/_torch_blocks.py``).

Beside each layer, its mixer and FFN, the MoE's pieces on the reference's
own ``ln2`` output: the router's f32 logits and gates (f32 sum order:
1.8e-6 and 8.9e-7 of their rms), the expert ids (equal), the routed
experts with the combine on the reference's gates and ids, and kimi's
shared expert.  Each differs in at most 0.21 % of its outputs and 0.052 %
beyond one bf16 ulp: bf16 products summed in another order, nothing
rounded elsewhere.  kimi's MoE layer reads 0.84 % of its outputs off and
0.37 % beyond an ulp (the layer's residual, norms and combine round where
the compiled reference rounds; what differs is the attention's flips
carried through the layer), under the 0.5 % its bound holds it to.  The
aux term and the loss agree to 1e-5 (measured 1.9e-6).

``BOUNDS``: as in ``tests/test_torch_blocks.py``; kimi's MoE layer is held
to 0.5 % beyond an ulp, below the rule's 0.56 %.  grok's head differs in
58 % of its logits (the final softcap's f32 tanh), 8e-6 beyond an ulp.
"""
import numpy as np
import pytest

from _torch_blocks import DTYPES, SEEDS, check, check_layer_body, reading
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b")
BOUNDS = {
    "grok-1-314b": {
        "attn:core:flash": ("shares", 0.00054, 0.0002, 0.000336, 0.0),
        "attn:out": ("shares", 0.00033, 0.0002, 0.000122, 0.0),
        "attn:qkv": ("shares", 0.00029, 0.00025, 8.1e-05, 4.1e-05),
        "embed": ("shares", 0.0, 0.0, 0.0, 0.0),
        "ffn:moe": ("shares", 0.0017, 0.00078, 0.00107, 0.000519),
        "head": ("shares", 0.87, 0.00021, 0.576, 8e-06),
        "layer:attn+moe": ("shares", 0.013, 0.0043, 0.00836, 0.00284),
        "mixer:attn": ("shares", 0.0088, 0.0019, 0.00583, 0.00125),
        "moe:experts": ("shares", 0.0017, 0.00078, 0.00107, 0.000519),
        "moe:gates": ("rel", 2e-06, 8.9e-07),
        "moe:router": ("rel", 3e-06, 1.81e-06),
    },
    "kimi-k2-1t-a32b": {
        "attn:core:flash": ("shares", 0.00051, 0.0002, 0.000305, 0.0),
        "attn:out": ("shares", 0.00036, 0.0002, 0.000153, 0.0),
        "attn:qkv": ("shares", 0.00025, 0.0002, 4.1e-05, 0.0),
        "embed": ("shares", 0.0, 0.0, 0.0, 0.0),
        "ffn:mlp": ("shares", 0.0061, 0.002, 0.00403, 0.00128),
        "ffn:moe": ("shares", 0.0021, 0.0006, 0.00137, 0.000397),
        "head": ("shares", 0.00031, 0.0002, 0.000107, 0.0),
        "layer:attn": ("shares", 0.0052, 0.0021, 0.00345, 0.00137),
        "layer:attn+moe": ("shares", 0.013, 0.005, 0.00836, 0.00372),
        "mixer:attn": ("shares", 0.0035, 0.00054, 0.00229, 0.000336),
        "moe:experts": ("shares", 0.00083, 0.00039, 0.000549, 0.000183),
        "moe:gates": ("rel", 2e-06, 7.72e-07),
        "moe:router": ("rel", 3e-06, 1.69e-06),
        "moe:shared": ("shares", 0.0032, 0.00051, 0.00208, 0.000305),
    },
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_hold_to_the_reference(arch, dtype, seed):
    """Every block on the reference's own stream from ``seed``: bf16 to
    its kind's bound in ``BOUNDS``, f32 to atol and rtol 1e-5."""
    pytest.importorskip("jax")
    check(reading(arch, dtype, seed), dtype, BOUNDS[arch])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_chained_blocks_are_the_model(arch, dtype):
    """The reference's jitted blocks, chained, give its own compiled
    model's output bit for bit (share that differs: 0 in every case), so
    each block stands for the block as the model runs it."""
    pytest.importorskip("jax")
    for name, (got, want) in reading(arch, dtype, SEEDS[0]).chain.items():
        assert np.array_equal(got, want), (
            f"{name}: {np.mean(got != want):.4%} differ")


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_body_is_apply_layer(arch):
    """The harness's layer body on a rounded input, handing nothing on, is
    ``transformer.apply_layer`` to the bit, in both dtypes."""
    pytest.importorskip("jax")
    check_layer_body(arch)

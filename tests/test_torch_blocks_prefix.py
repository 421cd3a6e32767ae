"""The ssm, vlm and enc-dec families, block by block against the JAX
package as it compiles it (mamba2-2.7b; paligemma-3b's prefix-LM over 16
stub prefix embeddings; seamless-m4t-medium's encoder over 8 stub frames
and its decoder with cross-attention; the harness is
``tests/_torch_blocks.py``).

Seamless's blocks are the bodies of the reference's ``encdec.encode`` and
``encdec.forward`` scans, written in the harness line for line from its
public ``layers`` ops, against ``encdec._encoder_layer`` and
``_decoder_layer``; beside them the encoder's final norm, the decoder's
self- and cross-attention (each with its projections, core and
out-projection) and the MLPs.  paligemma's attention core is the
prefix-LM's einsum path on both sides.

Every piece is within 0.05 % of the reference, at most 0.002 % beyond one
bf16 ulp: sum order.  The compositions read more where a flip moves a
row: seamless's first decoder layer up to 18 % differ and 8.4 % beyond an
ulp (seed 5; its self-attention's few flipped keys move every later
query), the cross-attention as a whole 1.3 % and 0.44 % (a flipped
projected key or value moves every decoder position).  mamba2's SSM mixer
reads 0.70 % and 0.12 %.

``BOUNDS``: as in ``tests/test_torch_blocks.py``.
"""
import numpy as np
import pytest

from _torch_blocks import DTYPES, SEEDS, check, check_layer_body, reading
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCHS = ("mamba2-2.7b", "paligemma-3b", "seamless-m4t-medium")
BOUNDS = {
    "mamba2-2.7b": {
        "embed": ("shares", 0.0, 0.0, 0.0, 0.0),
        "head": ("shares", 0.0022, 0.00049, 0.0014, 0.000282),
        "layer:ssm": ("shares", 0.0039, 0.0011, 0.00259, 0.000732),
        "mixer:ssm": ("shares", 0.011, 0.0018, 0.00702, 0.00119),
    },
    "paligemma-3b": {
        "attn:core:prefix": ("shares", 0.00025, 0.0002, 4.9e-05, 0.0),
        "attn:out": ("shares", 0.0005, 0.0002, 0.000293, 0.0),
        "attn:qkv": ("shares", 0.00033, 0.0002, 0.00013, 0.0),
        "embed": ("shares", 0.0, 0.0, 0.0, 0.0),
        "ffn:mlp": ("shares", 0.0031, 0.0004, 0.00205, 0.000195),
        "head": ("shares", 0.00031, 0.0002, 0.00011, 0.0),
        "layer:attn": ("shares", 0.074, 0.028, 0.0493, 0.0187),
        "mixer:attn": ("shares", 0.055, 0.013, 0.0366, 0.00815),
    },
    "seamless-m4t-medium": {
        "attn:core:cross": ("shares", 0.0002, 0.0002, 0.0, 0.0),
        "attn:core:flash": ("shares", 0.00074, 0.0002, 0.000488, 0.0),
        "attn:out": ("shares", 0.00045, 0.0002, 0.000244, 0.0),
        "attn:qkv": ("shares", 0.00045, 0.00022, 0.000244, 2e-05),
        "cross": ("shares", 0.02, 0.0066, 0.0128, 0.00439),
        "embed": ("shares", 0.0, 0.0, 0.0, 0.0),
        "enc_norm": ("shares", 0.0, 0.0, 0.0, 0.0),
        "ffn:mlp": ("shares", 0.0022, 0.00045, 0.00146, 0.000244),
        "head": ("shares", 0.00033, 0.0002, 0.000122, 0.0),
        "layer:dec": ("shares", 0.28, 0.13, 0.18, 0.0837),
        "layer:enc": ("shares", 0.026, 0.0099, 0.0168, 0.00659),
        "mixer:dec": ("shares", 0.066, 0.012, 0.0435, 0.00781),
        "mixer:enc": ("shares", 0.0037, 0.0002, 0.00244, 0.0),
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


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_layer_body_is_apply_layer(arch):
    """The harness's layer body on a rounded input, handing nothing on, is
    ``transformer.apply_layer`` to the bit, in both dtypes (paligemma
    with its prefix)."""
    pytest.importorskip("jax")
    check_layer_body(arch)

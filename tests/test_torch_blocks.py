"""The dense family, block by block against the JAX package as it
compiles it (smollm-135m, smollm-360m, stablelm-1.6b; the harness is
``tests/_torch_blocks.py``).

Each layer, its mixer and FFN, the attention's projections, core and
out-projection, the embedding, the head and the loss, on the reference's
own residual stream from token seeds 5, 6 and 7.  ``BOUNDS`` gives each
block kind's bf16 bound beside its measured value, the largest over the
three seeds (``PYTHONPATH=src python tests/_torch_blocks.py ARCH`` prints
them): ("shares", bound on the share of outputs that differ, bound on the
share more than one bf16 ulp off, measured, measured), or ("rel", bound,
measured) for a piece computed in f32.  A bound is the measured value
times 1.5, and at least 0.02 % above it, rounded up; the embedding is
exact.

Every piece is within 0.03 % of the reference, at most 0.003 % more than
one bf16 ulp off: what differs is sum order (the bf16 products' accumulation,
the flash kernel's plain version against the Pallas kernel's online
softmax, the norms' f32 sums), a single ulp per flip.  The whole mixer and
the layer read more (smollm-360m's layer: 14 % differ, 5.8 % beyond an
ulp) because one flip changes a whole row downstream: a flipped key moves
every query's scores, a flipped input of the out-projection or the MLP
moves every output of its row.  The harness holds the pieces tight and the
compositions at what that amplification gives; a rounding place that the
port moved shows at the piece (the RG-LRU conv's rounding, before it
followed the compiled reference, put 37-43 % of its layer's outputs off).
"""
import numpy as np
import pytest

from _torch_blocks import DTYPES, SEEDS, check, check_layer_body, reading
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCHS = ("smollm-135m", "smollm-360m", "stablelm-1.6b")
BOUNDS = {
    "smollm-135m": {
        "attn:core:flash": ("shares", 0.00033, 0.0002, 0.000122, 0.0),
        "attn:out": ("shares", 0.00037, 0.0002, 0.000163, 0.0),
        "attn:qkv": ("shares", 0.00035, 0.0002, 0.000146, 0.0),
        "embed": ("shares", 0.0, 0.0, 0.0, 0.0),
        "ffn:mlp": ("shares", 0.0039, 0.00053, 0.00256, 0.000326),
        "head": ("shares", 0.00031, 0.0002, 0.000107, 0.0),
        "layer:attn": ("shares", 0.023, 0.0089, 0.0151, 0.0059),
        "mixer:attn": ("shares", 0.012, 0.0016, 0.00769, 0.00106),
    },
    "smollm-360m": {
        "attn:core:flash": ("shares", 0.0005, 0.0002, 0.000293, 0.0),
        "attn:out": ("shares", 0.00046, 0.0002, 0.00026, 0.0),
        "attn:qkv": ("shares", 0.0004, 0.00022, 0.000195, 2e-05),
        "embed": ("shares", 0.0, 0.0, 0.0, 0.0),
        "ffn:mlp": ("shares", 0.0052, 0.00083, 0.00342, 0.000553),
        "head": ("shares", 0.0028, 0.00061, 0.00185, 0.000404),
        "layer:attn": ("shares", 0.22, 0.088, 0.14, 0.0583),
        "mixer:attn": ("shares", 0.048, 0.007, 0.0316, 0.00466),
    },
    "stablelm-1.6b": {
        "attn:core:flash": ("shares", 0.00045, 0.0002, 0.000244, 0.0),
        "attn:out": ("shares", 0.00042, 0.0002, 0.000214, 0.0),
        "attn:qkv": ("shares", 0.0003, 0.00024, 9.2e-05, 3.1e-05),
        "embed": ("shares", 0.0, 0.0, 0.0, 0.0),
        "ffn:mlp": ("shares", 0.0032, 0.00054, 0.00211, 0.000336),
        "head": ("shares", 0.00035, 0.0002, 0.000145, 0.0),
        "layer:attn": ("shares", 0.17, 0.061, 0.107, 0.0405),
        "mixer:attn": ("shares", 0.091, 0.015, 0.0601, 0.00992),
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

"""The families whose scanned group holds more than one layer, block by
block against the JAX package as it compiles it (gemma2-2b: local and
global attention with softcaps and post-norms; recurrentgemma-2b: two
RG-LRU layers and windowed MQA; the harness is ``tests/_torch_blocks.py``).

Inside one scanned group XLA hands a layer's last residual sum on to the
next layer's ``ln1`` in f32, unrounded: the norm's upcast swallows the
add's rounding.  Only the scan's carry is rounded.  Before the port did
the same (``transformer.apply_layer``'s ``hand_on``), the chained blocks
and the model differed in 69-74 % of the logits in bf16
(``test_chained_blocks_are_the_model``).  The RG-LRU's conv ends in a
SiLU whose last product ``_gates`` reads in f32: a forward drops that
product's rounding too, but under ``jax.value_and_grad`` the product is a
residual of the backward and rounds; the port rounds it where autograd
records it (``rglru._conv``;
``test_rglru_rounds_where_autodiff_saves_the_conv``).  Before, the RG-LRU
layers read 37-43 % of their outputs off the reference's forward and
15-19 % beyond an ulp (seeds 5-7); after, at most 5.5 % and 1.1 %
(``test_rglru_layer_remainder_is_the_conv_input_product`` pins what is
left to the sum order of ``x @ w_rec``, amplified along time by the
recurrence).

``BOUNDS``: as in ``tests/test_torch_blocks.py`` (bound beside the
largest measured value over token seeds 5, 6 and 7).  The RG-LRU's f32
pieces are held by ``rel_err``: the scan (the port's chunked closed form
against ``lax.associative_scan``: sum order alone, max 1.5e-6 of the rms),
log_a (f32 sigmoid and softplus, 4.8e-7) and the gated input (1.7e-5:
``sqrt(1 - a^2)`` cancels near a = 1).  The gelu branch's f32 output
differs in 24 % of its values (jax's f32 tanh against PyTorch's) and in
6e-5 beyond a bf16 ulp (a flip of ``x @ w_gelu``).  gemma2's head differs
in 58 % (the final softcap's f32 tanh), 5e-6 beyond a bf16 ulp.
"""
import numpy as np
import pytest

from _torch_blocks import (DTYPES, SEEDS, Pair, check, check_layer_body,
                           inputs, reading)
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCHS = ("gemma2-2b", "recurrentgemma-2b")
BOUNDS = {
    "gemma2-2b": {
        "attn:core:flash": ("shares", 0.00051, 0.0002, 0.000305, 0.0),
        "attn:out": ("shares", 0.00035, 0.0002, 0.000142, 0.0),
        "attn:qkv": ("shares", 0.0003, 0.00021, 9.2e-05, 1e-05),
        "embed": ("shares", 0.0, 0.0, 0.0, 0.0),
        "ffn:mlp": ("shares", 0.0041, 0.00074, 0.00271, 0.000488),
        "head": ("shares", 0.87, 0.00021, 0.576, 5e-06),
        "layer:attn": ("shares", 0.21, 0.085, 0.14, 0.0563),
        "layer:attn_local": ("shares", 0.2, 0.055, 0.128, 0.0364),
        "mixer:attn": ("shares", 0.061, 0.0098, 0.0406, 0.00653),
        "mixer:attn_local": ("shares", 0.038, 0.0066, 0.0248, 0.00435),
    },
    "recurrentgemma-2b": {
        "attn:core:flash": ("shares", 0.00037, 0.0002, 0.000163, 0.0),
        "attn:out": ("shares", 0.00031, 0.0002, 0.000102, 0.0),
        "attn:qkv": ("shares", 0.00027, 0.00022, 6.8e-05, 1.4e-05),
        "embed": ("shares", 0.0, 0.0, 0.0, 0.0),
        "ffn:mlp": ("shares", 0.0074, 0.0014, 0.00488, 0.000875),
        "head": ("shares", 0.0003, 0.0002, 9.7e-05, 0.0),
        "layer:attn_local": ("shares", 0.0087, 0.0033, 0.00574, 0.00218),
        "layer:rglru": ("shares", 0.083, 0.016, 0.0552, 0.0106),
        "mixer:attn_local": ("shares", 0.0047, 0.00083, 0.00313, 0.000549),
        "mixer:rglru": ("shares", 0.018, 0.0026, 0.0118, 0.00173),
        "rglru:conv": ("shares", 0.00033, 0.00027, 0.000122, 6.1e-05),
        "rglru:gated_x": ("rel", 3e-05, 1.67e-05),
        "rglru:gelu": ("shares", 0.36, 0.00027, 0.239, 6.1e-05),
        "rglru:log_a": ("rel", 8e-07, 4.8e-07),
        "rglru:out": ("shares", 0.00041, 0.0002, 0.000203, 0.0),
        "rglru:scan": ("rel", 3e-06, 1.45e-06),
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


@pytest.mark.parametrize("seed", SEEDS)
def test_rglru_layer_remainder_is_the_conv_input_product(monkeypatch, seed):
    """With the reference's conv output handed to the port's RG-LRU in
    place of its own, each RG-LRU layer is within 0.5 % of outputs beyond
    one bf16 ulp (measured at most 0.28 %, seed 5's first layer), where
    the whole layer reads up to 1.06 % (seed 7's first).  So what remains
    is ``x @ w_rec``'s sum order: a product that flips by an ulp in ~0.01 %
    of the conv's outputs (``rglru:conv`` in ``BOUNDS``), each flip carried
    along time by the recurrence and across the row by the MLP.  That is
    not a rounding place the port could move: XLA accumulates the bf16
    product in f32 in its own order, as the card's GEMM does in its own."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import torch
    from _torch_blocks import _np, _positions, _t, shares
    from repro_torch.models import rglru as T_RG
    from repro_torch.models import transformer as T_T
    pair = Pair.of("recurrentgemma-2b", "bfloat16")
    tok, _, _ = inputs(pair, seed)
    with jax.default_device(jax.devices("cpu")[0]), torch.no_grad():
        x = pair.embed(pair.params["embed"]["table"], jnp.asarray(tok), None)
        pos, tpos = _positions(x.shape[0], x.shape[1])
        xn = x
        for i, (lp, tlp, kind, hand_on) in enumerate(pair.layers()):
            y, _ = pair.layer(lp, x, xn, pos, kind=kind, hand_on=hand_on)
            if kind == "rglru":
                h = pair.norm(xn, lp["ln1"])
                xr = _t(pair.rglru_parts(lp["rglru"], h)[0])
                monkeypatch.setattr(T_RG, "_causal_conv",
                                    lambda *a, **k: (xr, None))
                got, _ = T_T.apply_layer(pair.t_cfg, tlp, kind, _t(xn),
                                         tpos, hand_on=hand_on)
                monkeypatch.undo()
                differ, far = shares(_np(got), _np(y))
                print(f"seed {seed} L{i}: differ {differ:.4%} far {far:.4%}")
                assert far <= 5e-3, (i, differ, far)
            xn, x = y, y.astype(jnp.bfloat16)


@pytest.mark.parametrize("seed", SEEDS)
def test_rglru_rounds_where_autodiff_saves_the_conv(seed):
    """The reference rounds the RG-LRU conv's last SiLU product where
    ``jax.value_and_grad`` saves it for the backward pass, and not in a
    forward alone: its two compiled runs of the first layer's block differ
    in 40-42 % of the outputs (12-13 % beyond an ulp).  The port rounds
    where autograd records the conv: a recorded run is held to the
    reference's ``value_and_grad`` run, a ``no_grad`` run to its forward,
    each within 2.4 % differ and 0.39 % beyond an ulp (measured at most
    1.55 % and 0.25 % recorded, 1.18 % and 0.17 % under ``no_grad``, both
    at seed 7, its ``x @ w_rec`` flips carried along time)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import torch
    from _torch_blocks import _np, _t, shares
    from repro.models import rglru as R_RG
    from repro_torch.models import rglru as T_RG
    pair = Pair.of("recurrentgemma-2b", "bfloat16")
    cfg = pair.r_cfg
    tok, _, _ = inputs(pair, seed)
    lp, tlp, _, _ = pair.layers()[0]
    w = np.random.default_rng(seed).normal(
        size=(len(tok), pair.seq, cfg.d_model)).astype(np.float32)

    def block(p, h):
        y = R_RG.rglru_forward(cfg, p, h)
        return jnp.sum(y.astype(jnp.float32) * w), y

    with jax.default_device(jax.devices("cpu")[0]):
        x = pair.embed(pair.params["embed"]["table"], jnp.asarray(tok), None)
        h = pair.norm(x, lp["ln1"])
        fwd = _np(jax.jit(block)(lp["rglru"], h)[1])
        vg = _np(jax.jit(jax.value_and_grad(block, has_aux=True))(
            lp["rglru"], h)[0][1])
    with torch.no_grad():
        plain = _np(T_RG.rglru_forward(pair.t_cfg, tlp["rglru"], _t(h)))
    rec = {k: v.detach().requires_grad_() for k, v in tlp["rglru"].items()}
    recorded = _np(T_RG.rglru_forward(pair.t_cfg, rec, _t(h)))
    modes = shares(vg, fwd)
    got = shares(recorded, vg), shares(plain, fwd)
    print(f"seed {seed}: reference vg vs forward {modes}; port recorded vs "
          f"vg {got[0]}, no_grad vs forward {got[1]}")
    assert modes[0] > 0.3
    for d, f in got:
        assert d <= 0.024 and f <= 0.0039, got

"""The port's decode path (caches, ``decode_step``, ``prefill_cache``), held
against the JAX package's.

Both packages decode the same tokens from the reference's init, teacher
forced, jax pinned to its CPU backend: the reference's prefill is
``transformer.prefill_cache`` under ``jax.jit`` (a ``lax.scan`` of
``decode_step``, compiled as the serving engine compiles it).  Smoke
configs of smollm-135m, gemma2-2b (window 8 over 40 tokens: five ring
wraparounds), mamba2-2.7b, grok-1-314b and kimi-k2 (a dense prelude layer,
a shared expert).  Logits: f32 to 5e-5 absolute (measured 6.7e-6); bf16 to
0.1 absolute (measured 0.0625: the port rounds where XLA's fused layer does,
and a few positions drift by a bf16 ulp of the cache, which the next steps
carry).  Greedy choices may differ only where the reference's top-2 gap is
under that tolerance.  The final caches agree to the same tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.dfl import flat_state as T_FS
from repro_torch.models import layers as T_L
from repro_torch.models import registry as T_R
from repro_torch.models import ssm as T_S
from repro_torch.models import transformer as T_T
from repro_torch.tree import tree_leaves

TOL = {"float32": 5e-5, "bfloat16": 0.1}
CASES = [("smollm-135m", None, 16), ("gemma2-2b", 8, 40),
         ("mamba2-2.7b", None, 16), ("grok-1-314b", None, 16),
         ("kimi-k2-1t-a32b", None, 16)]


def _paths(tree):
    import jax
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             np.asarray(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _cfgs(arch, dtype, window=None):
    from repro.models import registry as R_R
    extra = {} if window is None else {"window_size": window}
    return (dataclasses.replace(R_R.get_smoke_config(arch), dtype=dtype,
                                **extra),
            dataclasses.replace(T_R.get_smoke_config(arch), dtype=dtype,
                                **extra))


def near_tie_ok(got, want, tol):
    """Greedy choices of logits (..., V) agree wherever the reference's
    top-2 gap is at least ``tol``; returns the count of the other steps."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < tol
    same = got.argmax(-1) == want.argmax(-1)
    assert np.all(same | tie)
    return int((~same).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch, window, seq", CASES)
def test_prefill_cache_matches_reference(arch, window, seq, dtype):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.base import ShapeSpec as R_Shape
    from repro.models import registry as R_R
    from repro.models import transformer as R_T
    r_cfg, t_cfg = _cfgs(arch, dtype, window)
    tok = np.random.default_rng(2).integers(0, r_cfg.vocab_size,
                                            (2, seq)).astype(np.int32)
    with jax.default_device(jax.devices("cpu")[0]):
        params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(1))
        cache = R_R.init_decode_cache(r_cfg, R_Shape("d", 64, 2, "decode"))
        r_logits, r_cache = jax.jit(
            lambda p, c, t: R_T.prefill_cache(r_cfg, p, c, t))(
                params, cache, jnp.asarray(tok))
    t_params = T_FS.params_from_reference(_paths(params), "cpu")
    t_cache = T_R.init_decode_cache(t_cfg, ShapeSpec("d", 64, 2, "decode"))
    if window is not None:       # local layers hold a ring of the window
        assert t_cache["blocks"]["p0"]["k"].shape[2] == window
        assert t_cache["blocks"]["p1"]["k"].shape[2] == 64
    logits, t_cache = T_T.prefill_cache(t_cfg, t_params, t_cache,
                                        torch.from_numpy(tok))
    v = r_cfg.vocab_size
    got = logits.numpy()[..., :v]
    want = np.asarray(r_logits)[..., :v]
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)
    near_tie_ok(got, want, TOL[dtype])
    assert int(t_cache["pos"]) == int(r_cache["pos"]) == seq
    for a, b in zip(tree_leaves(t_cache), jax.tree.leaves(r_cache)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b).astype(np.float32),
                                   atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-2.7b",
                                  "grok-1-314b"])
def test_cache_handed_over_mid_stream_continues(arch):
    """The reference prefills 10 tokens; its cache, handed over, decodes the
    next 6 in the port as the reference decodes them (f32)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.base import ShapeSpec as R_Shape
    from repro.models import registry as R_R
    from repro.models import transformer as R_T
    r_cfg, t_cfg = _cfgs(arch, "float32")
    tok = np.random.default_rng(4).integers(0, r_cfg.vocab_size,
                                            (2, 16)).astype(np.int32)
    with jax.default_device(jax.devices("cpu")[0]):
        params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(3))
        cache = R_R.init_decode_cache(r_cfg, R_Shape("d", 32, 2, "decode"))
        step = jax.jit(lambda p, c, t: R_T.prefill_cache(r_cfg, p, c, t))
        _, cache = step(params, cache, jnp.asarray(tok[:, :10]))
        handed = jax.tree.map(np.asarray, cache)
        r_tail, _ = step(params, cache, jnp.asarray(tok[:, 10:]))
    t_cache = T_FS.cache_from_reference(handed, "cpu")
    assert int(t_cache["pos"]) == 10
    t_params = T_FS.params_from_reference(_paths(params), "cpu")
    tail, _ = T_T.prefill_cache(t_cfg, t_params, t_cache,
                                torch.from_numpy(tok[:, 10:]))
    np.testing.assert_allclose(tail.numpy()[..., :r_cfg.vocab_size],
                               np.asarray(r_tail)[..., :r_cfg.vocab_size],
                               atol=TOL["float32"], rtol=0)


def test_per_row_positions_match_rows_alone():
    """A (B,) position vector: each row decodes as it would alone, whatever
    the other rows' clocks (gemma2: window ring and global layer)."""
    cfg = dataclasses.replace(T_R.get_smoke_config("gemma2-2b"),
                              dtype="float32", window_size=8)
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 20),
                        generator=torch.Generator().manual_seed(1))
    alone = []
    for b, n in ((0, 20), (1, 12)):
        cache = T_R.init_decode_cache(cfg, ShapeSpec("d", 32, 1, "decode"))
        logits, _ = T_T.prefill_cache(cfg, params, cache, tok[b:b + 1, :n])
        alone.append(logits[0, -1])
    cache = T_R.init_decode_cache(cfg, ShapeSpec("d", 32, 2, "decode"))
    cache["pos"] = torch.zeros((2,), dtype=torch.int32)
    for i in range(20):
        if i == 8:               # row 1 restarts, its stale rows masked
            cache["pos"][1] = 0
        step = torch.stack([tok[0, i], tok[1, i - 8 if i >= 8 else i]])
        last, cache = T_R.serve_step(cfg, params, cache, step[:, None])
    torch.testing.assert_close(last[0, 0], alone[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(last[1, 0], alone[1], atol=1e-5, rtol=0)
    assert cache["pos"].tolist() == [20, 12]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multihead_attention_cache_step_matches_reference(dtype):
    """``multihead_attention(cache=..., cache_pos=...)``: one step written at
    ``cache_pos`` with the rows past it masked, as the reference's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import layers as R_L
    r_cfg, t_cfg = _cfgs("smollm-135m", dtype)
    rng = np.random.default_rng(6)
    hd, kv = r_cfg.resolved_head_dim, r_cfg.n_kv_heads
    k0 = rng.normal(size=(2, 12, kv, hd)).astype(np.float32)
    v0 = rng.normal(size=(2, 12, kv, hd)).astype(np.float32)
    x = rng.normal(size=(2, 1, r_cfg.d_model)).astype(np.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        params, _ = R_L.init_attention(jax.random.PRNGKey(0), r_cfg)
        dt = jnp.dtype(dtype)
        cache = {"k": jnp.asarray(k0).astype(dt), "v": jnp.asarray(v0)
                 .astype(dt)}
        pos = jnp.full((2, 1), 5, jnp.int32)
        r_y, r_new = R_L.multihead_attention(
            r_cfg, params, jnp.asarray(x).astype(dt), R_L.AttnSpec(), pos,
            cache=cache, cache_pos=jnp.asarray(5, jnp.int32))
    t_cache = T_FS.cache_from_reference(jax.tree.map(np.asarray, cache),
                                        "cpu")
    y, new = T_L.multihead_attention(
        t_cfg, T_FS.params_from_reference(_paths(params), "cpu"),
        T_FS.tensor_from_reference(np.asarray(jnp.asarray(x).astype(dt))),
        T_L.AttnSpec(), torch.full((2, 1), 5, dtype=torch.int32),
        cache=t_cache, cache_pos=5)
    tol = TOL[dtype] if dtype == "float32" else 2e-2
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(r_y.astype(jnp.float32)),
                               atol=tol, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            new[name].float().numpy(),
            np.asarray(r_new[name].astype(jnp.float32)), atol=tol, rtol=0)


def test_ssm_decode_step_matches_reference():
    """One recurrent step from a non-zero state and conv tail (f32)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import ssm as R_S
    r_cfg, t_cfg = _cfgs("mamba2-2.7b", "float32")
    rng = np.random.default_rng(8)
    with jax.default_device(jax.devices("cpu")[0]):
        p, _ = R_S.init_ssm(jax.random.PRNGKey(0), r_cfg)
        cache = R_S.init_ssm_cache(r_cfg, 2, jnp.float32)
        cache = jax.tree.map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(
                np.float32)) * 0.1, cache)
        x = jnp.asarray(rng.normal(size=(2, 1, r_cfg.d_model)).astype(
            np.float32))
        r_y, r_new = R_S.ssm_decode_step(r_cfg, p, cache, x)
    t_cache = T_FS.cache_from_reference(jax.tree.map(np.asarray, cache),
                                        "cpu")
    y, new = T_S.ssm_decode_step(
        t_cfg, T_FS.params_from_reference(_paths(p), "cpu"), t_cache,
        torch.from_numpy(np.array(x)))
    np.testing.assert_allclose(y.numpy(), np.asarray(r_y), atol=1e-5, rtol=0)
    for name in ("state", "conv_tail"):
        np.testing.assert_allclose(new[name].numpy(),
                                   np.asarray(r_new[name]), atol=1e-5,
                                   rtol=0)

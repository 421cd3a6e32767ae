"""The port's encoder-decoder family (seamless-m4t-medium: a bidirectional
encoder over stub audio frames, a causal decoder with cross-attention, and
enc-dec decoding), held against the JAX package.

The reference's own init, the same numpy tokens and the same numpy frames
go through both packages, jax pinned to its CPU backend; the reference's
self-attention (the encoder's non-causal, the decoder's causal) runs
through its Pallas flash kernel in interpret mode
(``KernelConfig(backend="pallas")``), as the port's runs through the flash
kernel's plain version here.  Cross-attention and every cached decode step
are einsums in both.  Tolerances:

* ``encode``, ``forward_logits``, ``compute_loss`` and every gradient at
  smoke geometry: those of ``tests/test_torch_models.py`` (f32: outputs
  and loss 1e-5, gradients 1e-4; bf16: loss 2e-3, gradients atol 5e-3 and
  rtol 5e-2, encoder outputs and logits 0.1, the decode tolerance);
* ``fill_cross_cache`` + ``E_prefill`` + ``decode_step`` streams, with the
  reference's frames injected: those of ``tests/test_torch_decode.py``
  (logits and caches f32 5e-5, bf16 0.1; greedy choices equal except at
  near ties);
* snapshots: bit for bit.

What the scalar bf16 bound can and cannot catch.  The loss gap against the
reference moves with the token seed: over seeds 5-10 it spans 1.2e-4 to 4.1e-3 (seeds 6, 7 and 9 are past
2e-3); the
reference's own bf16 loss differs from its f32 one by 7e-5 to 8.8e-3.  The
bound measures the spread of sum-order noise (bf16 products accumulated in
another order, each flip carried downstream), so it catches a wrong
function, not a rounding place moved: an ignored ``attn_impl="chunked"``
read 1.97e-3 on the vlm family, and a rounding of the RG-LRU conv's
output that the compiled reference's forward skips, which moved 38-43 %
of its layer's outputs, left the hybrid loss inside the same spread.  Rounding places are held block by block, on the
reference's own residual stream, by ``tests/test_torch_blocks*.py`` (the
harness is ``tests/_torch_blocks.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import io as CIO
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.protocol import DySTop
from repro_torch.dfl import flat_state as T_FS
from repro_torch.dfl import lm_worker as T_LW
from repro_torch.launch import serve as T_SERVE
from repro_torch.models import encdec as T_E
from repro_torch.models import registry as T_R
from repro_torch.serving import ServeEngine
from repro_torch.tree import tree_leaves, tree_map, tree_paths
from test_torch_decode import near_tie_ok
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCH = "seamless-m4t-medium"
B, S = 2, 32                     # frames_for(32) = 8


def _paths(tree):
    import jax
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             np.asarray(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _cfgs(dtype="float32"):
    from repro.models import registry as R_R
    return (dataclasses.replace(R_R.get_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(T_R.get_smoke_config(ARCH), dtype=dtype))


def _frames(cfg, n_frames, seed=6):
    return np.random.default_rng(seed).normal(
        size=(B, n_frames, cfg.d_model)).astype(np.float32)


def _close(got, want, f32, what):
    np.testing.assert_allclose(got, want, atol=1e-5 if f32 else 0.1,
                               rtol=1e-5 if f32 else 0, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_loss_grads_and_logits_match_reference(dtype):
    """The encoder (non-causal flash), the decoder (causal flash and
    cross-attention onto the encoder) and the tied head: loss, every
    gradient, the logits and the encoder's output."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.config import KernelConfig
    from repro.models import encdec as R_E
    from repro.models import registry as R_R
    r_cfg, t_cfg = _cfgs(dtype)
    pal = dataclasses.replace(r_cfg, kernels=KernelConfig(backend="pallas"))
    rng = np.random.default_rng(5)
    tok = rng.integers(0, r_cfg.vocab_size, size=(B, S)).astype(np.int32)
    lab = rng.integers(0, r_cfg.vocab_size, size=(B, S)).astype(np.int32)
    frames = _frames(r_cfg, R_R.frames_for(r_cfg, S))
    with jax.default_device(jax.devices("cpu")[0]):
        params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
                 "loss_mask": jnp.ones((B, S), jnp.float32),
                 "frames": jnp.asarray(frames).astype(jnp.dtype(dtype))}
        r_loss, r_grads = jax.value_and_grad(
            lambda p: R_R.compute_loss(pal, p, batch)[0])(params)
        r_logits = R_R.forward_logits(pal, params, batch)
        r_enc = R_E.encode(pal, params, batch["frames"])
    t_params = T_FS.params_from_reference(_paths(params), "cpu")
    t_batch = {"tokens": torch.from_numpy(tok),
               "labels": torch.from_numpy(lab), "loss_mask": torch.ones((B, S)),
               "frames": T_FS.tensor_from_reference(
                   np.asarray(batch["frames"]))}
    flat = [leaf.requires_grad_() for _, leaf in tree_paths(t_params)]
    loss, parts = T_R.compute_loss(t_cfg, t_params, t_batch)
    grads = torch.autograd.grad(loss, flat)
    with torch.no_grad():
        logits = T_R.forward_logits(t_cfg, t_params, t_batch)
        enc = T_E.encode(t_cfg, t_params, t_batch["frames"])
    f32 = dtype == "float32"
    assert float(parts["moe_aux"]) == 0.0
    v = r_cfg.vocab_size
    _close(logits.numpy()[..., :v],
           np.asarray(r_logits.astype(jnp.float32))[..., :v], f32, "logits")
    _close(enc.float().numpy(), np.asarray(r_enc.astype(jnp.float32)), f32,
           "encoder output")
    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               atol=1e-5 if f32 else 2e-3)
    for (path, _), got, want in zip(tree_paths(t_params), grads,
                                    jax.tree.leaves(r_grads)):
        want = np.asarray(want.astype(jnp.float32))
        assert np.abs(want).max() > 0, path           # every leaf trains
        if f32:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0,
                                       err_msg=str(path))
        else:
            np.testing.assert_allclose(got.float().numpy(), want, atol=5e-3,
                                       rtol=5e-2, err_msg=str(path))


def test_self_attention_goes_through_the_flash_kernel():
    """The encoder's self-attention reaches the flash entry with
    ``causal=False`` once per encoder layer, the decoder's with
    ``causal=True`` once per decoder layer; cross-attention never."""
    from repro_torch.kernels import ops as K
    cfg = T_R.get_smoke_config(ARCH)
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    calls = []
    orig = K.flash_attention_diff

    def rec(q, k, v, causal=True, window=None, softcap=None):
        calls.append((causal, tuple(q.shape), tuple(k.shape)))
        return orig(q, k, v, causal, window, softcap)

    tok = torch.zeros((1, 12), dtype=torch.int64)
    frames = torch.from_numpy(_frames(cfg, 8)[:1])
    K.flash_attention_diff = rec
    try:
        with torch.no_grad():
            T_R.forward_logits(cfg, params, {"tokens": tok, "frames": frames})
    finally:
        K.flash_attention_diff = orig
    h, d = cfg.n_heads, cfg.resolved_head_dim
    assert calls == ([(False, (1, h, 8, d), (1, h, 8, d))] * cfg.n_enc_layers
                     + [(True, (1, h, 12, d), (1, h, 12, d))] * cfg.n_layers)


@pytest.mark.parametrize("dtype, tol", [("float32", 5e-5),
                                        ("bfloat16", 0.1)])
def test_cross_cache_prefill_and_decode_match_reference(dtype, tol):
    """The reference's frames through ``fill_cross_cache``, then
    ``E_prefill`` over an 8-token prompt and 8 greedy ``serve_step``s:
    the logits of every step (over the whole vocabulary), the streams and
    the final caches (the self ring with ``k_pos``, the cross keys and
    values)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.base import ShapeSpec as R_Shape
    from repro.launch import serve as R_SERVE
    from repro.models import encdec as R_E
    from repro.models import registry as R_R
    r_cfg, t_cfg = _cfgs(dtype)
    max_len, gen = 40, 8
    n_frames = R_R.frames_for(r_cfg, max_len)
    assert T_R.frames_for(t_cfg, max_len) == n_frames == 10
    assert T_R.frames_for(t_cfg, 12) == R_R.frames_for(r_cfg, 12) == 8
    prompt = np.random.default_rng(2).integers(
        0, r_cfg.vocab_size, (B, 8)).astype(np.int32)
    with jax.default_device(jax.devices("cpu")[0]):
        params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(1))
        frames = jnp.asarray(_frames(r_cfg, n_frames)).astype(
            jnp.dtype(dtype))
        cache = R_R.init_decode_cache(r_cfg, R_Shape("d", max_len, B,
                                                     "decode"))
        cache = R_E.fill_cross_cache(r_cfg, params, cache, frames)
        r_pre, cache = R_SERVE.E_prefill(r_cfg, params, cache,
                                         jnp.asarray(prompt))
        step = jax.jit(lambda p, c, t: R_R.serve_step(r_cfg, p, c, t))
        tok, r_steps, r_toks = jnp.asarray(prompt[:, -1:]), [], []
        for _ in range(gen):
            lg, cache = step(params, cache, tok)
            r_steps.append(np.asarray(lg)[:, 0, :r_cfg.vocab_size])
            tok = jnp.argmax(lg[:, -1:, :r_cfg.vocab_size],
                             axis=-1).astype(jnp.int32)
            r_toks.append(np.asarray(tok))
    t_params = T_FS.params_from_reference(_paths(params), "cpu")
    t_cache = T_R.init_decode_cache(t_cfg, ShapeSpec("d", max_len, B,
                                                     "decode"))
    assert [(p, tuple(a.shape), a.dtype) for p, a in tree_paths(t_cache)] \
        == [(p, tuple(a.shape), T_FS.tensor_from_reference(a).dtype)
            for p, a in _paths(R_R.init_decode_cache(
                r_cfg, R_Shape("d", max_len, B, "decode")))]
    t_frames = T_FS.tensor_from_reference(np.asarray(frames))
    with torch.no_grad():
        assert T_E.fill_cross_cache(t_cfg, t_params, t_cache,
                                    t_frames) is t_cache
        pre, t_cache = T_SERVE.E_prefill(t_cfg, t_params, t_cache,
                                         torch.from_numpy(prompt))
        v = r_cfg.vocab_size
        np.testing.assert_allclose(pre.numpy()[..., :v],
                                   np.asarray(r_pre)[..., :v], atol=tol,
                                   rtol=0)
        # the reference's stream is fed back, so a near-tie flip does not
        # carry into the later steps' comparisons
        tok = torch.from_numpy(prompt[:, -1:])
        for want, r_tok in zip(r_steps, r_toks):
            lg, t_cache = T_R.serve_step(t_cfg, t_params, t_cache, tok)
            got = lg.numpy()[:, 0, :v]
            np.testing.assert_allclose(got, want, atol=tol, rtol=0)
            near_tie_ok(got, want, tol)
            tok = torch.from_numpy(np.array(r_tok)).long()
    assert int(t_cache["pos"]) == int(cache["pos"]) == 8 + gen
    for (path, a), (_, b) in zip(tree_paths(t_cache), _paths(cache)):
        np.testing.assert_allclose(a.float().numpy(), b.astype(np.float32),
                                   atol=tol, rtol=0, err_msg=str(path))


def test_engine_refuses_encdec_as_the_reference_does():
    jax = pytest.importorskip("jax")
    from repro.models import registry as R_R
    from repro.serving import ServeEngine as R_Engine
    r_cfg, t_cfg = _cfgs()
    with jax.default_device(jax.devices("cpu")[0]):
        r_params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match="decoder-only"):
            R_Engine(r_cfg, r_params, batch_slots=2, max_len=32)
    params = T_R.init_params(t_cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(t_cfg, params, batch_slots=2, max_len=32, device="cpu")


def test_configs_and_init_layout_match_reference():
    """Both configs carry the reference's fields; the port's init has the
    reference's leaves (``encoder``, ``decoder`` with ``xattn`` and
    ``ln_x``, ``enc_norm``, ``final_norm``), shapes and dtypes in its order
    at smoke geometry and, on the meta device against ``jax.eval_shape``,
    at full size: 12 + 12 layers, 715,454,464 parameters (1.43 GB as
    stored)."""
    jax = pytest.importorskip("jax")
    from repro.models import registry as R_R
    for get in ("get_config", "get_smoke_config"):
        r = dataclasses.asdict(getattr(R_R, get)(ARCH))
        t = dataclasses.asdict(getattr(T_R, get)(ARCH))
        r.pop("kernels"), t.pop("kernels")
        assert r == t, get

    def layout(tree):
        return [(p, tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
                for p, leaf in tree]

    with jax.default_device(jax.devices("cpu")[0]):
        r_params, _ = R_R.init_params(R_R.get_smoke_config(ARCH),
                                      jax.random.PRNGKey(0))
        full_r = jax.eval_shape(lambda: R_R.init_params(
            R_R.get_config(ARCH), jax.random.PRNGKey(0))[0])
    t_params = T_R.init_params(T_R.get_smoke_config(ARCH),
                               torch.Generator().manual_seed(0))
    assert layout(tree_paths(t_params)) == layout(_paths(r_params))
    assert not bool(t_params["enc_norm"].any())
    full_t = T_R.init_params(T_R.get_config(ARCH), None)
    want = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             tuple(leaf.shape), str(leaf.dtype))
            for p, leaf in jax.tree_util.tree_flatten_with_path(full_r)[0]]
    assert layout(tree_paths(full_t)) == want
    assert sum(leaf.numel() for leaf in tree_leaves(full_t)) == 715_454_464
    assert sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(full_t)) == 1_431_035_904


def test_snapshot_cross_loads_both_ways(tmp_path):
    """An enc-dec tree the reference's ``save_checkpoint`` wrote loads into
    the port's template bit for bit, and the port's file loads back into
    the reference's (bf16 leaves widened to f32 exactly)."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint import io as R_CIO
    from repro.models import registry as R_R
    r_cfg, t_cfg = _cfgs("bfloat16")
    with jax.default_device(jax.devices("cpu")[0]):
        r_params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(4))
        R_CIO.save_checkpoint(tmp_path / "ref.npz", r_params,
                              extra={"arch": r_cfg.arch_id})
    tmpl = tree_map(torch.zeros_like, T_R.init_params(
        t_cfg, torch.Generator().manual_seed(0)))
    got, _, extra = CIO.load_checkpoint(tmp_path / "ref.npz", tmpl)
    assert extra == {"arch": r_cfg.arch_id}
    want = T_FS.params_from_reference(_paths(r_params), "cpu")
    for (pa, a), (pb, b) in zip(tree_paths(got), tree_paths(want)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa
    CIO.save_checkpoint(tmp_path / "port.npz", got)
    with jax.default_device(jax.devices("cpu")[0]):
        back, _, _ = R_CIO.load_checkpoint(
            tmp_path / "port.npz", jax.tree.map(np.zeros_like, r_params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(r_params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_fleet_refuses_the_family_as_the_reference_cannot_train_it():
    """The reference's fleet fails at its first row-step (``KeyError:
    'frames'``: its row-step feeds tokens, labels and the loss mask only);
    the port refuses at set-up with a ``ValueError`` naming that feed."""
    jax = pytest.importorskip("jax")
    from repro.core.protocol import DySTop as R_DySTop
    from repro.dfl import lm_worker as R_LW
    r_cfg, t_cfg = _cfgs()
    kw = dict(n_workers=2, n_rounds=1, batch=1, seq=8, eval_every=1)
    with jax.default_device(jax.devices("cpu")[0]):
        with pytest.raises(KeyError, match="frames"):
            R_LW.run_lm_federation(R_DySTop(V=3.0, t_thre=10,
                                            max_neighbors=1), r_cfg,
                                   R_LW.LMRunConfig(**kw))
    with pytest.raises(ValueError, match=r"batch\['frames'\]"):
        T_LW.run_lm_federation(DySTop(V=3.0, t_thre=10, max_neighbors=1),
                               t_cfg, T_LW.LMRunConfig(**kw), device="cpu")

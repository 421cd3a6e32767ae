"""The port's vlm family (paligemma-3b: a prefix-LM over stub image
embeddings), held against the JAX package.

The reference's own init, the same numpy tokens and the same numpy prefix
embeddings go through both packages, jax pinned to its CPU backend (the
prefix keeps attention off the reference's Pallas path, and the port's
off its flash kernel: both run the einsum path on the prefix-LM mask).
Tolerances:

* ``forward_logits`` and ``compute_loss`` with every gradient at smoke
  geometry: those of ``tests/test_torch_models.py`` (f32: logits and loss
  1e-5, gradients 1e-4; bf16: loss 2e-3, gradients atol 5e-3 and rtol
  5e-2, logits 0.1, the decode tolerance); with ``attn_impl="chunked"``
  against the reference's chunked path the same, but the bf16 loss within
  1e-3;
* the engine's greedy streams (text only, as the reference's engine
  serves this family): equal in f32;
* snapshots: bit for bit.

What the scalar bf16 bound can and cannot catch.  The loss gap against the
reference moves with the token seed: over seeds 5-10 it spans 6.4e-5 to 4.8e-3 (seeds 7, 8 and 10 are past
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
from repro_torch.core.protocol import DySTop
from repro_torch.dfl import flat_state as T_FS
from repro_torch.dfl import lm_worker as T_LW
from repro_torch.models import registry as T_R
from repro_torch.models import transformer as T_T
from repro_torch.serving import ServeEngine
from repro_torch.tree import tree_leaves, tree_map, tree_paths
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCH = "paligemma-3b"
B, S = 2, 24                     # text tokens after the smoke's 16 prefix


def _paths(tree):
    import jax
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             np.asarray(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _cfgs(dtype="float32", **kw):
    from repro.models import registry as R_R
    return (dataclasses.replace(R_R.get_smoke_config(ARCH), dtype=dtype,
                                **kw),
            dataclasses.replace(T_R.get_smoke_config(ARCH), dtype=dtype,
                                **kw))


def _inputs(cfg, seed=5):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    pre = rng.normal(size=(B, cfg.n_prefix_tokens, cfg.d_model)).astype(
        np.float32)
    return tok, lab, pre


def _reference(dtype, **kw):
    """The reference's params, loss, gradients and logits on one batch,
    with the prefix embeddings in the activation dtype (``kw`` replaces
    config fields in both packages)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import registry as R_R
    r_cfg, t_cfg = _cfgs(dtype, **kw)
    tok, lab, pre = _inputs(r_cfg)
    with jax.default_device(jax.devices("cpu")[0]):
        params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
                 "loss_mask": jnp.ones((B, S), jnp.float32),
                 "prefix_embeds": jnp.asarray(pre).astype(jnp.dtype(dtype))}
        loss, grads = jax.value_and_grad(
            lambda p: R_R.compute_loss(r_cfg, p, batch)[0])(params)
        logits = R_R.forward_logits(r_cfg, params, batch)
    t_batch = {"tokens": torch.from_numpy(tok),
               "labels": torch.from_numpy(lab),
               "loss_mask": torch.ones((B, S)),
               "prefix_embeds": T_FS.tensor_from_reference(
                   np.asarray(batch["prefix_embeds"]))}
    return (r_cfg, t_cfg, params, float(loss),
            [np.asarray(g.astype(jnp.float32)) for g in jax.tree.leaves(grads)],
            np.asarray(logits.astype(jnp.float32)), t_batch)


def _check_against_reference(dtype, loss_tol_bf16, **kw):
    r_cfg, t_cfg, r_params, r_loss, r_grads, r_logits, batch = \
        _reference(dtype, **kw)
    params = T_FS.params_from_reference(_paths(r_params), "cpu")
    flat = [leaf.requires_grad_() for _, leaf in tree_paths(params)]
    loss, parts = T_R.compute_loss(t_cfg, params, batch)
    grads = torch.autograd.grad(loss, flat)
    with torch.no_grad():
        logits = T_R.forward_logits(t_cfg, params, batch)
    f32 = dtype == "float32"
    assert float(parts["moe_aux"]) == 0.0
    assert logits.shape == r_logits.shape == (
        B, r_cfg.n_prefix_tokens + S, 1024)
    v = r_cfg.vocab_size
    np.testing.assert_allclose(logits.numpy()[..., :v], r_logits[..., :v],
                               atol=1e-5 if f32 else 0.1, rtol=0)
    np.testing.assert_allclose(float(loss.detach()), r_loss,
                               atol=1e-5 if f32 else loss_tol_bf16)
    for (path, _), got, want in zip(tree_paths(params), grads, r_grads):
        assert np.abs(want).max() > 0, path           # every leaf trains
        if f32:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0,
                                       err_msg=str(path))
        else:
            np.testing.assert_allclose(got.float().numpy(), want, atol=5e-3,
                                       rtol=5e-2, err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_loss_grads_and_logits_match_reference(dtype):
    """The prefix goes in front unscaled (the token embeddings alone carry
    ``sqrt(d_model)``), attends both ways among itself, and the loss skips
    it; ``forward_logits`` keeps its positions, as the reference's does."""
    _check_against_reference(dtype, 2e-3)


@pytest.mark.parametrize("chunk", [8, 12, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_prefix_attention_matches_reference(dtype, chunk):
    """``attn_impl="chunked"`` on the prefix-LM against the reference's
    ``_chunked_attention`` over the 40 positions (16 prefix + 24 text):
    5 kv blocks of 8, 4 blocks of 12 with the last padded, one block of
    40.  The bf16 loss within 1e-3 (the einsum path is 1.97e-3 off the
    reference's chunked loss here), the rest at the einsum path's
    bounds."""
    _check_against_reference(dtype, 1e-3, attn_impl="chunked",
                             attn_chunk=chunk)


def test_chunked_without_prefix_is_flash_bit_for_bit():
    """Without a prefix the self-attention goes through flash whatever
    ``attn_impl`` says, as the reference's Pallas backend does: smollm's
    smoke logits under "chunked" equal those under "naive" bit for bit."""
    cfg = T_R.get_smoke_config("smollm-135m")
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 40)).astype(np.int32))
    with torch.no_grad():
        naive = T_T.forward(cfg, params, tok)[0]
        chunked = T_T.forward(dataclasses.replace(
            cfg, attn_impl="chunked", attn_chunk=8), params, tok)[0]
    assert torch.equal(naive, chunked)


def test_chunked_prefix_step_counts_the_same_on_meta_and_cpu():
    """``loopcost.step_costs`` of a chunked prefix-LM train step counts
    the online softmax's ops by dispatch: the same FLOPs, bytes and peak
    on ``meta`` and on the CPU, more bytes than the einsum path's, and no
    kernel call."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import loopcost as LC
    from repro_torch.launch import steps as T_S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import get_optimizer
    shape = ShapeSpec("smoke", 40, 2, "train")
    opt = get_optimizer("adam")
    counts = {}
    for impl in ("chunked", "naive"):
        cfg = dataclasses.replace(T_R.get_smoke_config(ARCH),
                                  attn_impl=impl, attn_chunk=8)
        art = T_S.build_train_artifacts(cfg, shape, make_host_mesh("cpu"),
                                        opt)
        for dev in ("meta", "cpu"):
            gen = None if dev == "meta" else torch.Generator().manual_seed(0)
            params = T_R.init_params(cfg, gen)
            batch = T_R.batch_specs(cfg, shape)
            if gen is not None:
                batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                         for k, v in batch.items()}
            c = LC.step_costs(art.step_fn, params, opt.init(params), batch)
            counts[impl, dev] = (c.dot_flops, c.io_bytes, c.peak_bytes,
                                 c.arg_bytes, dict(c.kernel_calls))
    assert counts["chunked", "meta"] == counts["chunked", "cpu"]
    assert counts["naive", "meta"] == counts["naive", "cpu"]
    assert counts["chunked", "cpu"][1] != counts["naive", "cpu"][1]
    assert not counts["chunked", "cpu"][4]


def test_prefix_is_bidirectional_and_text_is_causal():
    """Changing the last prefix embedding moves the logits at the first
    prefix position (the prefix sees itself both ways); changing the last
    text token moves nothing before it."""
    cfg = T_R.get_smoke_config(ARCH)
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    tok, _, pre = _inputs(cfg, seed=7)
    pre, tok = torch.from_numpy(pre), torch.from_numpy(tok)
    with torch.no_grad():
        base = T_T.forward(cfg, params, tok, prefix_embeds=pre)[0]
        pre2 = pre.clone()
        pre2[:, -1] += 1.0
        moved = T_T.forward(cfg, params, tok, prefix_embeds=pre2)[0]
        tok2 = tok.clone()
        tok2[:, -1] = (tok2[:, -1] + 1) % cfg.vocab_size
        last = T_T.forward(cfg, params, tok2, prefix_embeds=pre)[0]
    assert not torch.equal(moved[:, 0], base[:, 0])
    assert torch.equal(last[:, :-1], base[:, :-1])
    assert not torch.equal(last[:, -1], base[:, -1])


def test_configs_and_init_layout_match_reference():
    """Both configs carry the reference's fields; the port's init has the
    reference's leaves, shapes and dtypes in its order at smoke geometry
    and, on the meta device against ``jax.eval_shape``, at full size: 18
    layers, 2,508,793,856 parameters (5.02 GB as stored)."""
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
    full_t = T_R.init_params(T_R.get_config(ARCH), None)
    want = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             tuple(leaf.shape), str(leaf.dtype))
            for p, leaf in jax.tree_util.tree_flatten_with_path(full_r)[0]]
    assert layout(tree_paths(full_t)) == want
    n = sum(leaf.numel() for leaf in tree_leaves(full_t))
    assert n == 2_508_793_856
    assert sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(full_t)) == 5_017_739_264


def test_engine_streams_match_reference_f32():
    """Text-only greedy streams of the reference's ``ServeEngine`` through
    2 slots, from the reference's init with its norm scales drawn away from
    zero (so a stream does not simply repeat its last token)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import registry as R_R
    from repro.serving import ServeEngine as R_Engine
    from repro_torch.serving import TrafficConfig, generate_requests
    r_cfg, t_cfg = _cfgs()
    reqs = generate_requests(TrafficConfig(n_requests=4, prompt_len=(4, 9),
                                           gen_len=(5, 9), seed=3),
                             r_cfg.vocab_size)
    rng = np.random.default_rng(11)
    with jax.default_device(jax.devices("cpu")[0]):
        params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: (jnp.asarray(rng.normal(size=a.shape) * 2.0,
                                      a.dtype)
                          if "ln" in str(p[-1]) or "norm" in str(p[-1])
                          else a), params)
        ref = R_Engine(r_cfg, params, batch_slots=2, max_len=32)
        for r in reqs:
            ref.submit(r.prompt, r.gen)
        want = ref.run()
    eng = ServeEngine(t_cfg, T_FS.params_from_reference(_paths(params),
                                                        "cpu"),
                      batch_slots=2, max_len=32, device="cpu")
    for r in reqs:
        eng.submit(r.prompt, r.gen)
    got = eng.run()
    assert got == want
    assert any(len(set(s)) > 1 for s in got.values())


def test_snapshot_cross_loads_both_ways(tmp_path):
    """A vlm tree the reference's ``save_checkpoint`` wrote loads into the
    port's template bit for bit, and the port's file loads back into the
    reference's (bf16 leaves as their bits)."""
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
    'prefix_embeds'``: its row-step feeds tokens, labels and the loss mask
    only); the port refuses at set-up with a ``ValueError`` naming that
    feed."""
    jax = pytest.importorskip("jax")
    from repro.core.protocol import DySTop as R_DySTop
    from repro.dfl import lm_worker as R_LW
    r_cfg, t_cfg = _cfgs()
    kw = dict(n_workers=2, n_rounds=1, batch=1, seq=8, eval_every=1)
    with jax.default_device(jax.devices("cpu")[0]):
        with pytest.raises(KeyError, match="prefix_embeds"):
            R_LW.run_lm_federation(R_DySTop(V=3.0, t_thre=10,
                                            max_neighbors=1), r_cfg,
                                   R_LW.LMRunConfig(**kw))
    with pytest.raises(ValueError, match=r"batch\['prefix_embeds'\]"):
        T_LW.run_lm_federation(DySTop(V=3.0, t_thre=10, max_neighbors=1),
                               t_cfg, T_LW.LMRunConfig(**kw), device="cpu")

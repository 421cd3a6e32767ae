"""The port's hybrid family (recurrentgemma-2b: RG-LRU blocks and windowed
MQA attention), held against the JAX package.

The reference's own init and the same numpy inputs go through both
packages, jax pinned to its CPU backend.  Tolerances:

* the scan (``rglru.linear_scan``, a chunked closed form) against the
  reference's ``lax.associative_scan``, and ``rglru_forward`` in f32: atol
  and rtol 1e-5 (the two sum the same terms in another order);
* ``compute_loss`` and every gradient at smoke geometry, seq 96 past the
  window of 64, with the reference's attention through its Pallas flash
  kernel in interpret mode: those of ``tests/test_torch_models.py`` (f32:
  loss 1e-5, gradients 1e-4; bf16: loss 2e-3, gradients atol 5e-3 and
  rtol 5e-2);
* decoding past the window (window 8 over 32 tokens: the ring and the
  RG-LRU state both run on) and the engine's greedy streams: those of
  ``tests/test_torch_decode.py`` and ``tests/test_torch_serving.py``;
* the federation: those of ``tests/test_torch_lm.py`` (f32 1e-4, bf16
  1e-2 on ``loss_global``), the control plane identical.

The reference's bf16 RG-LRU rounds its conv's last SiLU product under
``jax.value_and_grad`` (a residual of the backward) and not in a forward
alone, and the port follows it (``rglru._conv``): ``compute_loss`` with
gradients, as here, runs the rounded product in both.

What the scalar bf16 bound can and cannot catch.  The loss gap against the
reference moves with the token seed: over seeds 5-10 it spans 9.1e-4 to 1.3e-3 (the reference's own
loss under ``value_and_grad`` and in a forward alone differ by up to
1.1e-3); the
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
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import io as CIO
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.protocol import DySTop
from repro_torch.dfl import flat_state as T_FS
from repro_torch.dfl import lm_worker as T_LW
from repro_torch.models import registry as T_R
from repro_torch.models import rglru as T_RG
from repro_torch.models import transformer as T_T
from repro_torch.serving import GenerationConfig, ServeEngine
from repro_torch.tree import tree_leaves, tree_paths
from test_torch_decode import near_tie_ok
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCH = "recurrentgemma-2b"
B, S = 2, 96                      # S past the smoke window of 64
CONTROL = ("rounds", "sim_time", "comm_gb", "staleness_avg", "staleness_max",
           "round_durations", "round_active")
FED_KW = dict(n_workers=4, n_rounds=9, batch=2, seq=80, eval_every=3, seed=1)


def _paths(tree):
    import jax
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             np.asarray(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _cfgs(dtype="float32", **kw):
    from repro.models import registry as R_R
    return (dataclasses.replace(R_R.get_smoke_config(ARCH), dtype=dtype, **kw),
            dataclasses.replace(T_R.get_smoke_config(ARCH), dtype=dtype, **kw))


def _rglru_params(seed=0):
    """The reference's init of one RG-LRU block (smoke width, f32)."""
    jax = pytest.importorskip("jax")
    from repro.models import rglru as R_RG
    r_cfg, t_cfg = _cfgs()
    with jax.default_device(jax.devices("cpu")[0]):
        rp, _ = R_RG.init_rglru(jax.random.PRNGKey(seed), r_cfg)
    return r_cfg, t_cfg, rp, T_FS.params_from_reference(_paths(rp), "cpu")


# --------------------------------------------------------------------------- #
# the RG-LRU block
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("s", [1, 16, 17, 96, 300])
def test_linear_scan_matches_associative_scan(s):
    """Lengths below, at and past one chunk, and past two levels; decays
    from the model's range up to a = e^-2 a step."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    rng = np.random.default_rng(s)
    la = -(rng.random((2, s, 24)) * np.linspace(0.001, 2.0, 24)).astype(
        np.float32)
    b = rng.normal(size=(2, s, 24)).astype(np.float32)

    def combine(left, right):
        return left[0] + right[0], jnp.exp(right[0]) * left[1] + right[1]

    with jax.default_device(jax.devices("cpu")[0]):
        _, want = jax.lax.associative_scan(
            combine, (jnp.asarray(la), jnp.asarray(b)), axis=1)
    got = T_RG.linear_scan(torch.from_numpy(la), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_linear_scan_gradient_is_finite_and_matches():
    """The pairs s > t are masked before ``exp``: a long run of strong
    decays (exponents past f32's ``exp`` limit in the unmasked pairs)
    gives finite gradients, equal to the sequential loop's."""
    g = torch.Generator().manual_seed(0)
    la = (-torch.rand((1, 200, 4), generator=g) * 3.0).requires_grad_()
    b = torch.randn((1, 200, 4), generator=g).requires_grad_()
    w = torch.randn((1, 200, 4), generator=g)
    ga, gb = torch.autograd.grad((T_RG.linear_scan(la, b) * w).sum(),
                                 (la, b))
    la64, b64 = (t.detach().double().requires_grad_() for t in (la, b))
    h, hs = torch.zeros((1, 4), dtype=torch.float64), []
    for t in range(200):
        h = torch.exp(la64[:, t]) * h + b64[:, t]
        hs.append(h)
    wa, wb = torch.autograd.grad((torch.stack(hs, 1) * w.double()).sum(),
                                 (la64, b64))
    assert bool(torch.isfinite(ga).all() and torch.isfinite(gb).all())
    np.testing.assert_allclose(ga.numpy(), wa.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gb.numpy(), wb.numpy(), atol=1e-4, rtol=1e-4)


def test_rglru_forward_matches_reference():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rglru as R_RG
    r_cfg, t_cfg, rp, tp = _rglru_params()
    x = np.random.default_rng(1).normal(size=(B, S, r_cfg.d_model)).astype(
        np.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        want = R_RG.rglru_forward(r_cfg, rp, jnp.asarray(x))
    got = T_RG.rglru_forward(t_cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_rglru_decode_step_matches_reference():
    """Six steps from a zero cache: outputs and the carried state (h f32,
    the conv tail) as the reference's; the port writes the cache in
    place."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rglru as R_RG
    r_cfg, t_cfg, rp, tp = _rglru_params(2)
    xs = np.random.default_rng(3).normal(size=(6, B, 1, r_cfg.d_model)).astype(
        np.float32)
    cache = T_RG.init_rglru_cache(t_cfg, B, torch.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        r_cache = R_RG.init_rglru_cache(r_cfg, B, jnp.float32)
        for x in xs:
            want, r_cache = R_RG.rglru_decode_step(r_cfg, rp, r_cache,
                                                   jnp.asarray(x))
            got, new = T_RG.rglru_decode_step(t_cfg, tp, cache,
                                              torch.from_numpy(x))
            assert new is cache
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)
    for k in ("h", "conv_tail"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(r_cache[k]),
                                   atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_loss_and_grads_match_reference(dtype):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.config import KernelConfig
    from repro.models import registry as R_R
    r_cfg, t_cfg = _cfgs(dtype)
    pal = dataclasses.replace(r_cfg, kernels=KernelConfig(backend="pallas"))
    rng = np.random.default_rng(5)
    tok = rng.integers(0, r_cfg.vocab_size, size=(B, S)).astype(np.int32)
    lab = rng.integers(0, r_cfg.vocab_size, size=(B, S)).astype(np.int32)
    with jax.default_device(jax.devices("cpu")[0]):
        r_params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
                 "loss_mask": jnp.ones((B, S), jnp.float32)}
        r_loss, r_grads = jax.value_and_grad(
            lambda p: R_R.compute_loss(pal, p, batch)[0])(r_params)
    params = T_FS.params_from_reference(_paths(r_params), "cpu")
    flat = [leaf.requires_grad_() for _, leaf in tree_paths(params)]
    loss, parts = T_R.compute_loss(t_cfg, params, {
        "tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
        "loss_mask": torch.ones((B, S))})
    assert float(parts["moe_aux"]) == 0.0
    grads = torch.autograd.grad(loss, flat)
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               atol=1e-5 if f32 else 2e-3)
    for (path, _), got, want in zip(tree_paths(params), grads,
                                    jax.tree.leaves(r_grads)):
        want = np.asarray(want.astype(jnp.float32))
        assert np.abs(want).max() > 0, path           # every leaf trains
        if f32:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0,
                                       err_msg=str(path))
        else:
            np.testing.assert_allclose(got.float().numpy(), want, atol=5e-3,
                                       rtol=5e-2, err_msg=str(path))


def test_init_layout_and_configs_match_reference():
    """Both configs carry the reference's fields; the port's init has the
    reference's leaves, shapes and dtypes in its order at smoke geometry,
    at 5 layers (one period and a two-layer ``rglru`` coda) and, on the
    meta device against ``jax.eval_shape``, at full size: 26 layers, 8
    periods and the coda, 2,894,574,080 parameters.  ``lam`` is the
    reference's to 2e-5 relative (XLA's and PyTorch's ``pow`` differ in
    the last bit near 1, and the ``- 1`` before ``expm1`` cancels all but
    ~7 bits of that), the biases are zero."""
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

    r5, t5 = _cfgs("bfloat16", n_layers=5)
    assert T_T.structure(t5) == (0, 1, 2)
    with jax.default_device(jax.devices("cpu")[0]):
        for r_cfg, t_cfg in (_cfgs("bfloat16"), (r5, t5)):
            r_params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(0))
            t_params = T_R.init_params(t_cfg,
                                       torch.Generator().manual_seed(0))
            assert layout(tree_paths(t_params)) == layout(_paths(r_params))
        rg_r = r_params["coda"][1]["rglru"]
        rg_t = t_params["coda"][1]["rglru"]
        np.testing.assert_allclose(rg_t["lam"].numpy(),
                                   np.asarray(rg_r["lam"]), rtol=2e-5)
        for k in ("b_a", "b_x", "conv_b"):
            assert not bool(rg_t[k].any())
        full_r = jax.eval_shape(lambda: R_R.init_params(
            R_R.get_config(ARCH), jax.random.PRNGKey(0))[0])
    full_t = T_R.init_params(T_R.get_config(ARCH), None)
    assert T_T.structure(T_R.get_config(ARCH)) == (0, 8, 2)
    want = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             tuple(leaf.shape), str(leaf.dtype))
            for p, leaf in jax.tree_util.tree_flatten_with_path(full_r)[0]]
    assert layout(tree_paths(full_t)) == want
    assert sum(leaf.numel() for leaf in tree_leaves(full_t)) == 2_894_574_080


def test_prefill_decode_past_the_window_matches_reference():
    """Window 8 over 32 tokens (as ``tests/test_decode_caches.py::
    test_hybrid_wraparound``): the ring wraps four times and the RG-LRU
    state runs on; logits and the final caches within the decode
    tolerances, in f32 and bf16."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.base import ShapeSpec as R_Shape
    from repro.models import registry as R_R
    from repro.models import transformer as R_T
    for dtype, tol in (("float32", 5e-5), ("bfloat16", 0.1)):
        r_cfg, t_cfg = _cfgs(dtype, window_size=8)
        tok = np.random.default_rng(2).integers(0, r_cfg.vocab_size,
                                                (2, 32)).astype(np.int32)
        with jax.default_device(jax.devices("cpu")[0]):
            params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(1))
            cache = R_R.init_decode_cache(r_cfg, R_Shape("d", 48, 2,
                                                         "decode"))
            r_logits, r_cache = jax.jit(
                lambda p, c, t: R_T.prefill_cache(r_cfg, p, c, t))(
                    params, cache, jnp.asarray(tok))
        t_params = T_FS.params_from_reference(_paths(params), "cpu")
        t_cache = T_R.init_decode_cache(t_cfg, ShapeSpec("d", 48, 2,
                                                         "decode"))
        assert t_cache["blocks"]["p2"]["k"].shape[2] == 8     # the ring
        assert t_cache["blocks"]["p0"]["h"].dtype == torch.float32
        logits, t_cache = T_T.prefill_cache(t_cfg, t_params, t_cache,
                                            torch.from_numpy(tok))
        v = r_cfg.vocab_size
        got, want = logits.numpy()[..., :v], np.asarray(r_logits)[..., :v]
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
        near_tie_ok(got, want, tol)
        assert int(t_cache["pos"]) == int(r_cache["pos"]) == 32
        for a, b in zip(tree_leaves(t_cache), jax.tree.leaves(r_cache)):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b).astype(np.float32),
                                       atol=tol, rtol=0)


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #


def test_engine_streams_match_reference_f32():
    """Greedy streams of the reference's ``ServeEngine`` past the window
    (8) from the reference's init, through 2 slots."""
    jax = pytest.importorskip("jax")
    from repro.models import registry as R_R
    from repro.serving import ServeEngine as R_Engine
    from repro_torch.serving import TrafficConfig, generate_requests
    r_cfg, t_cfg = _cfgs(window_size=8)
    reqs = generate_requests(TrafficConfig(n_requests=4, prompt_len=(6, 10),
                                           gen_len=(6, 10), seed=3),
                             r_cfg.vocab_size)
    with jax.default_device(jax.devices("cpu")[0]):
        params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(0))
        ref = R_Engine(r_cfg, params, batch_slots=2, max_len=32)
        for r in reqs:
            ref.submit(r.prompt, r.gen)
        want = ref.run()
    eng = ServeEngine(t_cfg, T_FS.params_from_reference(_paths(params),
                                                        "cpu"),
                      batch_slots=2, max_len=32, device="cpu")
    for r in reqs:
        eng.submit(r.prompt, r.gen)
    assert eng.run() == want


def test_admission_zeroes_the_rglru_state():
    """A slot reused by a second request starts from a fresh row (the
    rglru ``h`` and conv tail zeroed, the ring's stale keys masked): its
    stream is the one it gets alone."""
    cfg = dataclasses.replace(T_R.get_smoke_config(ARCH), dtype="float32",
                              window_size=8)
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    g = GenerationConfig(max_new_tokens=6)
    prompts = [np.arange(1, 13), np.arange(40, 47)]
    eng = ServeEngine(cfg, params, batch_slots=1, max_len=32, device="cpu")
    rids = [eng.submit(p, g) for p in prompts]
    out = eng.run()
    assert bool(eng.cache["blocks"]["p0"]["h"].abs().sum() > 0)
    alone = ServeEngine(cfg, params, batch_slots=1, max_len=32, device="cpu")
    rid = alone.submit(prompts[1], g)
    assert out[rids[1]] == alone.run()[rid]


def test_serve_cli_runs_recurrentgemma_smoke_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "4",
         "--gen", "3"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(
            os.path.dirname(__file__), "..", "src")})
    assert out.returncode == 0, out.stderr
    assert "arch=recurrentgemma-2b-smoke batch=2 device=cpu" in out.stdout


# --------------------------------------------------------------------------- #
# the fleet
# --------------------------------------------------------------------------- #


def _mech():
    return DySTop(V=3.0, t_thre=10, max_neighbors=3)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-4),
                                        ("bfloat16", 1e-2)])
def test_federation_matches_reference(dtype, tol):
    """9 rounds at seq 80, past the window: the control plane identical,
    ``loss_global`` within the LM fleet's tolerance."""
    jax = pytest.importorskip("jax")
    from repro.core.protocol import DySTop as R_DySTop
    from repro.dfl import lm_worker as R_LW
    r_cfg, t_cfg = _cfgs(dtype)
    with jax.default_device(jax.devices("cpu")[0]):
        init = R_LW.init_fleet(r_cfg, FED_KW["n_workers"],
                               seed=FED_KW["seed"])
        _, r_hist = R_LW.run_lm_federation(
            R_DySTop(V=3.0, t_thre=10, max_neighbors=3), r_cfg,
            R_LW.LMRunConfig(**FED_KW))
    _, hist = T_LW.run_lm_federation(
        _mech(), t_cfg, T_LW.LMRunConfig(**FED_KW), device="cpu",
        init=(np.asarray(init.pbuf), np.asarray(init.obuf)))
    for f in CONTROL:
        assert getattr(hist, f) == getattr(r_hist, f), f
    assert max(hist.round_active) > 1
    assert np.isfinite(hist.loss_global).all()
    np.testing.assert_allclose(hist.loss_global, r_hist.loss_global,
                               atol=tol, rtol=0)


def test_fleet_layout_matches_reference():
    """The hybrid fleet's columns, shapes and mixed dtypes (the f32
    ``lam``, ``b_a``, ``b_x`` among bf16 leaves) are the reference's, and
    ``fleet_from_reference`` carries its buffers across bit for bit."""
    jax = pytest.importorskip("jax")
    from repro.dfl import lm_worker as R_LW
    with jax.default_device(jax.devices("cpu")[0]):
        ref = R_LW.init_fleet(_cfgs("bfloat16")[0], 3, seed=2)
    fleet = T_LW.init_fleet(T_R.get_smoke_config(ARCH), 3, device="cpu")
    for mine, theirs in ((fleet.spec.params, ref.spec.params),
                         (fleet.spec.opt, ref.spec.opt)):
        assert mine.offsets == theirs.offsets and mine.shapes == theirs.shapes
        assert [str(d).replace("torch.", "") for d in mine.dtypes] \
            == list(theirs.dtypes)
    assert list(fleet.spec.params.keys) == [p for p, _ in _paths(
        ref.stacked_params)]
    pbuf, obuf = T_FS.fleet_from_reference(np.asarray(ref.pbuf),
                                           np.asarray(ref.obuf), fleet.spec,
                                           "cpu")
    np.testing.assert_array_equal(pbuf.numpy(), np.asarray(ref.pbuf))
    np.testing.assert_array_equal(obuf.numpy(), np.asarray(ref.obuf))


def test_hybrid_snapshot_resume_round_trip(tmp_path):
    """A hybrid fleet resumed from its round-2 snapshot finishes on the
    uninterrupted run exactly, buffers included; the last snapshot holds
    the final fleet bit for bit, and ``serving.bridge`` serves its worker
    0 with that row's leaves."""
    cfg = T_R.get_smoke_config(ARCH)
    run = T_LW.LMRunConfig(n_workers=3, n_rounds=4, batch=2, seq=16,
                           eval_every=2, seed=1, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path))
    mech = lambda: DySTop(V=3.0, t_thre=3, max_neighbors=3)   # noqa: E731
    full_f, full = T_LW.run_lm_federation(mech(), cfg, run, device="cpu")
    snaps = CIO.list_checkpoints(tmp_path)
    assert len(snaps) == 2
    res_f, res = T_LW.run_lm_federation(mech(), cfg, run, str(snaps[0]),
                                        device="cpu")
    for f in CONTROL + ("loss_global", "loss_local", "round_loss"):
        assert getattr(res, f) == getattr(full, f), f
    assert torch.equal(res_f.pbuf, full_f.pbuf)
    assert torch.equal(res_f.obuf, full_f.obuf)
    blobs, extra = CIO.read_checkpoint(snaps[1])
    assert extra["config"]["arch"] == cfg.arch_id
    np.testing.assert_array_equal(blobs["params|pbuf"], full_f.pbuf.numpy())
    from repro_torch.serving import bridge as BR
    served = BR.serving_params_from_checkpoint(snaps[1], cfg, worker=0,
                                               device="cpu")
    want = T_FS.unravel_tree(full_f.pbuf[0], full_f.spec.params, copy=True)
    for (pa, a), (pb, b) in zip(tree_paths(served), tree_paths(want)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa
    eng = BR.engine_from_checkpoint(snaps[1], cfg, worker=0, batch_slots=2,
                                    max_len=32, device="cpu")
    rid = eng.submit(np.arange(1, 9), GenerationConfig(max_new_tokens=4))
    assert len(eng.run()[rid]) == 4

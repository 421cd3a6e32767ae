"""The port's moe family and its ``moe_router`` kernel, held against the JAX
package.

On the CPU the router's wrapper runs its plain version; that is held
against the Pallas ``moe_router`` in interpret mode and against the JAX
package's oracle ``moe_router_ref``, on the same numpy logits, jax pinned
to its CPU backend: ids identical, gates to 1e-6.  ``moe_ffn`` goes through
both packages from the reference's init on grok-1-314b and kimi-k2 smoke
(kimi: shared expert), with the reference routing through its Pallas
router (``KernelConfig(backend="pallas")``) or its ``lax.top_k`` path: f32
to 1e-5 absolute (measured 1.3e-6); bf16 to two bf16 ulps of the value
(rtol 2^-7) plus 4e-3 (measured: at most 0.07% of the outputs apart, by at
most 3.9e-3, the sums of the expert products in another order).
Training: ``moe_router_diff`` against the JAX package's in interpret mode
(ids identical, gates and the logits' gradient within 1e-6), grok smoke's
``compute_loss`` with its ``moe_aux`` and every gradient against
``jax.value_and_grad`` at ``tests/test_torch_models.py``'s tolerances, and
a 9-round federation at ``tests/test_torch_lm.py``'s; kimi-k2's in bf16
at the same tolerances.
The CUDA kernel runs only on a card (``test_cuda_moe_router_matches_plain``,
marker ``cuda``).

What the scalar bf16 bound can and cannot catch.  The loss gap against the
reference moves with the token seed: over seeds 5-10 it spans 1.5e-4 to 1.2e-3 (grok) and 9.5e-4 to 3.8e-3
(kimi: seeds 7-9 are past 2e-3, and at seed 7 its router and embedding
gradients are 1.6-2.1 times their tolerance while the f32 gradients
agree within 5e-5: the backward's bf16 rounding; the forward's blocks
agree, ``tests/test_torch_blocks_moe.py``); the
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

from repro_torch.dfl import flat_state as T_FS
from repro_torch.kernels import moe_router as T_MR
from repro_torch.models import moe as T_M
from repro_torch.models import registry as T_R
from repro_torch.tree import tree_paths
from test_torch_resume import _one_torch_thread  # noqa: F401

MOE = ("grok-1-314b", "kimi-k2-1t-a32b")


def _paths(tree):
    import jax
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             np.asarray(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _logits(t, e, seed, ties=False):
    """Random logits; with ``ties``, rows of all-equal logits, rows whose
    maximum repeats, rows of +-1e4 and rows tied below the top."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(t, e)) * 3).astype(np.float32)
    if ties:
        x[0] = 1.0
        x[1] = -5.0
        x[1, [2, min(5, e - 1)]] = 2.0
        x[2, : e // 2] = 1e4
        x[2, e // 2:] = -1e4
        x[3] = np.where(np.arange(e) % 3 == 0, 0.5, -0.5)
        x[4, -1] = x[4].max() + 1.0
        x[4, :2] = x[4, -1]
    return x


# E = 4 is the moe smoke fleet's routing (the kernel's 8-lane segment half
# empty)
ROUTER_CASES = [(8, 8, 2, False), (300, 8, 2, False), (64, 384, 8, False),
                (16, 8, 2, True), (16, 384, 8, True), (128, 4, 2, False),
                (16, 4, 2, True)]


@pytest.mark.parametrize("t, e, k, ties", ROUTER_CASES)
def test_moe_router_plain_matches_pallas(t, e, k, ties):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import moe_router as R_MR
    from repro.kernels import ref as R_REF
    x = _logits(t, e, t * 1000 + e, ties)
    gates, ids = T_MR.moe_router(torch.from_numpy(x), k)
    assert gates.dtype == torch.float32 and ids.dtype == torch.int32
    with jax.default_device(jax.devices("cpu")[0]):
        p_gates, p_ids = R_MR.moe_router(jnp.asarray(x), k, interpret=True)
        r_gates, r_ids = R_REF.moe_router_ref(jnp.asarray(x), k)
    for want_g, want_i in ((p_gates, p_ids), (r_gates, r_ids)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(gates.numpy(), np.asarray(want_g),
                                   atol=1e-6, rtol=0)
    assert np.isfinite(gates.numpy()).all()


def test_moe_router_plain_breaks_ties_by_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0], [0.0] * 5])
    gates, ids = T_MR.moe_router_plain(x, 3)
    assert ids.tolist() == [[1, 2, 4], [0, 1, 2]]
    torch.testing.assert_close(gates, torch.full((2, 3), 1 / 3))


@pytest.mark.parametrize("t, e, k", [(8, 0, 1), (8, 513, 2), (8, 8, 9),
                                     (8, 64, 17), (0, 8, 2), (8, 8, 0)])
def test_moe_router_check_sizes_rejects(t, e, k):
    with pytest.raises(ValueError):
        T_MR.check_sizes(t, e, k)


def test_moe_router_wrapper_rejects_bad_input():
    with pytest.raises(ValueError, match="logits must be"):
        T_MR.moe_router(torch.zeros((2, 3, 4)), 2)
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        T_MR.moe_router(_on_xpu(torch.zeros((2, 4))), 2)
    # meta has no data: empty outputs of the right shapes and dtypes
    gates, ids = T_MR.moe_router(torch.zeros((2, 4), device="meta"), 2)
    assert (gates.shape, gates.dtype, ids.shape, ids.dtype) == (
        (2, 2), torch.float32, (2, 2), torch.int32)
    assert gates.device.type == ids.device.type == "meta"


class _Xpu(torch.Tensor):
    """A tensor that says it lies on a device with no kernel here."""
    @property
    def device(self):
        return torch.device("xpu")


def _on_xpu(t):
    return torch.Tensor._make_subclass(_Xpu, t)


@pytest.mark.parametrize("capacity, t", [(8, 32), (4, 16)])
def test_dispatch_indices_matches_reference(capacity, t):
    """Slots and keep mask of the sort-based dispatch, drops included."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import moe as R_M
    rng = np.random.default_rng(capacity)
    eids = np.stack([rng.choice(4, 2, replace=False) for _ in range(t)])
    eids = eids.astype(np.int32)
    with jax.default_device(jax.devices("cpu")[0]):
        r_slots, r_keep = R_M.dispatch_indices(jnp.asarray(eids), 4, capacity)
    slots, keep = T_M.dispatch_indices(torch.from_numpy(eids), 4, capacity)
    assert not np.asarray(r_keep).all()                # drops are exercised
    np.testing.assert_array_equal(slots.numpy(), np.asarray(r_slots))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(r_keep))


def test_dispatch_groups_are_independent():
    """With G groups each group's positions and drops are those it gets
    alone, its slots offset by g * C inside each expert's G * C rows."""
    rng = np.random.default_rng(3)
    eids = torch.from_numpy(np.stack([
        np.stack([rng.choice(4, 2, replace=False) for _ in range(12)])
        for _ in range(3)]).astype(np.int32))
    slots, keep = T_M.dispatch_indices(eids, 4, 8)
    for g in range(3):
        s1, k1 = T_M.dispatch_indices(eids[g], 4, 8)
        part = slice(g * 24, (g + 1) * 24)
        assert torch.equal(keep[part], k1)
        e, pos = s1 // 8, s1 % 8
        want = torch.where(k1, e * 24 + g * 8 + pos, 4 * 24)
        assert torch.equal(slots[part], want)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_moe_ffn_matches_reference(arch, dtype, backend):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.config import KernelConfig
    from repro.models import moe as R_M
    from repro.models import registry as R_R
    cfg = dataclasses.replace(R_R.get_smoke_config(arch), dtype=dtype,
                              kernels=KernelConfig(backend=backend))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        params, _ = R_R.init_params(cfg, jax.random.PRNGKey(0))
        mp = jax.tree.map(lambda leaf: leaf[0], params["blocks"]["p0"]["moe"])
        xj = jnp.asarray(x).astype(cfg.dtype)
        r_y, r_aux = R_M.moe_ffn(cfg, mp, xj)
    t_cfg = dataclasses.replace(T_R.get_smoke_config(arch), dtype=dtype)
    y, aux = T_M.moe_ffn(t_cfg, T_FS.params_from_reference(_paths(mp), "cpu"),
                         T_FS.tensor_from_reference(np.asarray(xj)))
    assert y.dtype == getattr(torch, dtype)
    want = np.asarray(r_y.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(y.float().numpy(), want, atol=4e-3,
                                   rtol=2 ** -7)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-6)


def test_moe_ffn_per_row_routes_each_row_alone():
    """``per_row``: every batch row is its own capacity group, so a row's
    output is what it gets alone — at 12 rows of one token on grok smoke
    (E = 4, k = 2) one shared group of capacity 8 drops choices, the
    per-row groups (capacity 8 each) drop none."""
    cfg = dataclasses.replace(T_R.get_smoke_config("grok-1-314b"),
                              dtype="float32")
    p = T_M.init_moe(torch.Generator().manual_seed(0), cfg)
    # twelve near-copies of one token: they all pick the same two experts
    g = torch.Generator().manual_seed(1)
    x = (torch.randn((1, 1, cfg.d_model), generator=g)
         + 0.01 * torch.randn((12, 1, cfg.d_model), generator=g))
    _, eids, _ = T_M.route(cfg, p["router"], x.reshape(12, -1))
    _, keep = T_M.dispatch_indices(eids, cfg.moe.n_experts,
                                   T_M.expert_capacity(cfg, 12))
    assert not bool(keep.all())               # the shared group drops
    y, _ = T_M.moe_ffn(cfg, p, x, per_row=True)
    for b in range(12):
        alone, _ = T_M.moe_ffn(cfg, p, x[b:b + 1])
        torch.testing.assert_close(y[b:b + 1], alone, atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_and_layout_match_reference(arch):
    jax = pytest.importorskip("jax")
    from repro.models import registry as R_R
    for get in ("get_config", "get_smoke_config"):
        r = dataclasses.asdict(getattr(R_R, get)(arch))
        t = dataclasses.asdict(getattr(T_R, get)(arch))
        r.pop("kernels"), t.pop("kernels")
        assert r == t, get
    with jax.default_device(jax.devices("cpu")[0]):
        r_params, _ = R_R.init_params(R_R.get_smoke_config(arch),
                                      jax.random.PRNGKey(0))
    for gen in (torch.Generator().manual_seed(0), None):
        t_params = T_R.init_params(T_R.get_smoke_config(arch), gen)
        got = [(p, tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
               for p, leaf in tree_paths(t_params)]
        want = [(p, leaf.shape, str(leaf.dtype))
                for p, leaf in _paths(r_params)]
        assert got == want


def test_moe_family_trains():
    """``compute_loss`` on grok smoke is ce + router_aux_weight * moe_aux,
    and every leaf, the router's among them, gets a finite gradient."""
    cfg = dataclasses.replace(T_R.get_smoke_config("grok-1-314b"),
                              dtype="float32")
    p = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    batch = {"tokens": tok, "labels": torch.roll(tok, 1, dims=1)}
    leaves = [leaf.requires_grad_() for _, leaf in tree_paths(p)]
    loss, parts = T_R.compute_loss(cfg, p, batch)
    assert cfg.moe.router_aux_weight == 1e-2
    assert float(parts["moe_aux"].detach()) > 0
    torch.testing.assert_close(loss, parts["ce"] + 1e-2 * parts["moe_aux"],
                               rtol=0, atol=0)
    grads = torch.autograd.grad(loss, leaves)
    for (path, _), gr in zip(tree_paths(p), grads):
        assert bool(torch.isfinite(gr).all()) and bool(gr.abs().sum() > 0), \
            path
    logits = T_R.forward_logits(cfg, p, batch)      # inference runs
    assert logits.shape == (2, 16, 1024)


ROUTER_DIFF_CASES = [(16, 8, 2, True), (64, 384, 8, False)]


@pytest.mark.parametrize("t, e, k, ties", ROUTER_DIFF_CASES)
def test_moe_router_diff_matches_reference(t, e, k, ties):
    """``ops.moe_router_diff`` against the JAX package's in interpret mode:
    ids identical, gates and the logits' gradient (of a random weighting
    of the gates) within 1e-6; the ids carry no gradient."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as R_K
    from repro.kernels.config import KernelConfig
    from repro_torch.kernels import ops as T_K
    x = _logits(t, e, t + e, ties)
    w = np.random.default_rng(e).normal(size=(t, k)).astype(np.float32)
    kc = KernelConfig(backend="pallas")
    with jax.default_device(jax.devices("cpu")[0]):
        r_gates, r_ids = R_K.moe_router_diff(jnp.asarray(x), k, kc)
        r_grad = jax.grad(lambda l: jnp.sum(
            R_K.moe_router_diff(l, k, kc)[0] * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    gates, ids = T_K.moe_router_diff(xt, k)
    assert not ids.requires_grad and ids.dtype == torch.int32
    (grad,) = torch.autograd.grad((gates * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    np.testing.assert_allclose(gates.detach().numpy(), np.asarray(r_gates),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(r_grad), atol=1e-6,
                               rtol=0)
    assert bool(torch.isfinite(grad).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_loss_and_router_grads_match_reference(dtype):
    """grok smoke, from the reference's init, the reference routing
    through its Pallas router and flash kernel in interpret mode: the loss,
    its ``moe_aux`` and every gradient, the router's included, at
    ``tests/test_torch_models.py``'s tolerances (f32: 1e-5 on the loss,
    1e-4 on the gradients; bf16: 2e-3, atol 5e-3 and rtol 5e-2).
    ``moe_aux``: rtol 1e-6 in f32; 1e-4 in bf16, where the router reads
    activations that round at other places in the two packages (the ids,
    and so f_e, agree)."""
    assert _check_compute_loss("grok-1-314b", dtype) == 1   # stacked


def test_kimi_compute_loss_and_grads_match_reference_bf16():
    """kimi-k2 smoke in bf16 (a dense prelude layer, then a MoE layer with
    a shared expert), as grok's case above: loss within 2e-3 (measured
    9.5e-4 at token seed 5), every gradient within atol 5e-3 and rtol
    5e-2 (the largest measured error 0.29 of that), ``moe_aux`` rtol
    1e-4.  Seeds 6-10 measure loss gaps up to 3.8e-3 and, at seed 7,
    router and embedding gradients 1.6-2.1 times the tolerance, where
    the f32 gradients agree within 5e-5: the backward's bf16 rounding
    (``ROADMAP.md``, Queue C), not a forward block
    (``tests/test_torch_blocks_moe.py``)."""
    assert _check_compute_loss("kimi-k2-1t-a32b", "bfloat16") == 1


def _check_compute_loss(arch, dtype):
    """``compute_loss`` of ``arch``'s smoke config, from the reference's
    init on token seed 5, against ``jax.value_and_grad`` of the
    reference's; returns the number of router leaves checked."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.config import KernelConfig
    from repro.models import registry as R_R
    r_cfg = dataclasses.replace(R_R.get_smoke_config(arch),
                                dtype=dtype,
                                kernels=KernelConfig(backend="pallas"))
    rng = np.random.default_rng(5)
    tok = rng.integers(0, r_cfg.vocab_size, size=(2, 32)).astype(np.int32)
    lab = rng.integers(0, r_cfg.vocab_size, size=(2, 32)).astype(np.int32)
    with jax.default_device(jax.devices("cpu")[0]):
        r_params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
                 "loss_mask": jnp.ones((2, 32), jnp.float32)}
        (r_loss, r_parts), r_grads = jax.value_and_grad(
            lambda p: R_R.compute_loss(r_cfg, p, batch), has_aux=True)(
                r_params)
    params = T_FS.params_from_reference(_paths(r_params), "cpu")
    flat = [leaf.requires_grad_() for _, leaf in tree_paths(params)]
    cfg = dataclasses.replace(T_R.get_smoke_config(arch),
                              dtype=dtype)
    loss, parts = T_R.compute_loss(cfg, params, {
        "tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
        "loss_mask": torch.ones((2, 32))})
    grads = torch.autograd.grad(loss, flat)
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(parts["moe_aux"].detach()),
                               float(r_parts["moe_aux"]),
                               rtol=1e-6 if f32 else 1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               atol=1e-5 if f32 else 2e-3)
    routers = 0
    for (path, _), got, want in zip(tree_paths(params), grads,
                                    jax.tree.leaves(r_grads)):
        want = np.asarray(want.astype(jnp.float32))
        routers += path[-1] == "router"
        if f32:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0,
                                       err_msg=str(path))
        else:
            np.testing.assert_allclose(got.float().numpy(), want, atol=5e-3,
                                       rtol=5e-2, err_msg=str(path))
    return routers




def test_dropped_choices_give_zero_gradient():
    """Choices past an expert's capacity land on the dummy row, which is
    discarded before the expert products: a token whose every choice is
    dropped gets a zero output and a zero input gradient, and the expert
    weights' gradient is what the kept tokens alone give."""
    cfg = dataclasses.replace(T_R.get_smoke_config("grok-1-314b"),
                              dtype="float32")
    p = T_M.init_moe(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    # 24 near-copies of one token pick the same two experts: capacity 16
    # keeps the first 16 and drops both choices of the last 8
    x = (torch.randn((1, 1, cfg.d_model), generator=g)
         + 0.01 * torch.randn((1, 24, cfg.d_model), generator=g))
    _, eids, _ = T_M.route(cfg, p["router"], x[0])
    assert bool((eids == eids[0]).all())
    assert T_M.expert_capacity(cfg, 24) == 16
    w = torch.randn((1, 24, cfg.d_model), generator=g)
    experts = [p[k].requires_grad_() for k in ("w_gate", "w_up", "w_down")]
    xg = x.clone().requires_grad_()
    y, _ = T_M.moe_ffn(cfg, p, xg)
    gx, *gw = torch.autograd.grad((y * w).sum(), [xg] + experts)
    assert not bool(y[0, 16:].any()) and not bool(gx[0, 16:].any())
    assert bool(gx[0, :16].abs().sum(-1).gt(0).all())
    kept, _ = T_M.moe_ffn(cfg, p, x[:, :16])
    want = torch.autograd.grad((kept * w[:, :16]).sum(), experts)
    for a, b in zip(gw, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-4),
                                        ("bfloat16", 1e-2)])
def test_moe_federation_matches_reference(dtype, tol):
    """grok smoke in the LM fleet, 9 rounds, 4 workers, from the
    reference's initial buffers: the control plane identical,
    ``loss_global`` within tests/test_torch_lm.py's tolerances."""
    jax = pytest.importorskip("jax")
    from repro.core.protocol import DySTop as R_DySTop
    from repro.dfl import lm_worker as R_LW
    from repro.models import registry as R_R
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import lm_worker as T_LW
    kw = dict(n_workers=4, n_rounds=9, batch=2, seq=16, eval_every=3, seed=1)
    r_cfg = dataclasses.replace(R_R.get_smoke_config("grok-1-314b"),
                                dtype=dtype)
    with jax.default_device(jax.devices("cpu")[0]):
        init = R_LW.init_fleet(r_cfg, kw["n_workers"], seed=kw["seed"])
        _, r_hist = R_LW.run_lm_federation(
            R_DySTop(V=3.0, t_thre=10, max_neighbors=3), r_cfg,
            R_LW.LMRunConfig(**kw))
    cfg = dataclasses.replace(T_R.get_smoke_config("grok-1-314b"),
                              dtype=dtype)
    _, hist = T_LW.run_lm_federation(
        DySTop(V=3.0, t_thre=10, max_neighbors=3), cfg,
        T_LW.LMRunConfig(**kw), device="cpu",
        init=(np.asarray(init.pbuf), np.asarray(init.obuf)))
    for f in ("rounds", "sim_time", "comm_gb", "staleness_avg",
              "staleness_max", "round_durations", "round_active"):
        assert getattr(hist, f) == getattr(r_hist, f), f
    assert max(hist.round_active) > 1
    assert np.isfinite(hist.loss_global).all()
    np.testing.assert_allclose(hist.loss_global, r_hist.loss_global,
                               atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_moe_router_matches_plain():
    """On the card: ids identical, gates within 1e-6, at the decode shape,
    a ragged T, kimi's E = 384, the smoke fleet's E = 4, and the tie
    rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the moe_router kernel has no CPU "
                    "mode (its plain version is tested above)")
    before = T_MR.launches
    for t, e, k, ties in ROUTER_CASES + [(4096, 384, 8, False),
                                         (4096, 8, 2, True)]:
        x = torch.from_numpy(_logits(t, e, t + e, ties)).cuda()
        gates, ids = T_MR.moe_router(x, k)
        p_gates, p_ids = T_MR.moe_router_plain(x, k)
        torch.cuda.synchronize()
        assert torch.equal(ids, p_ids), (t, e, k, ties)
        torch.testing.assert_close(gates, p_gates, atol=1e-6, rtol=0)
        assert bool(torch.isfinite(gates).all())
    assert T_MR.launches == before + len(ROUTER_CASES) + 2

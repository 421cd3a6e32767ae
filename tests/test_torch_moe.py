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
The CUDA kernel runs only on a card (``test_cuda_moe_router_matches_plain``,
marker ``cuda``).
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
        x[1, [2, 5]] = 2.0
        x[2, : e // 2] = 1e4
        x[2, e // 2:] = -1e4
        x[3] = np.where(np.arange(e) % 3 == 0, 0.5, -0.5)
        x[4, -1] = x[4].max() + 1.0
        x[4, :2] = x[4, -1]
    return x


ROUTER_CASES = [(8, 8, 2, False), (300, 8, 2, False), (64, 384, 8, False),
                (16, 8, 2, True), (16, 384, 8, True)]


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
    with pytest.raises(ValueError, match="no kernel for device"):
        T_MR.moe_router(torch.zeros((2, 4), device="meta"), 2)


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


def test_moe_family_does_not_train_yet():
    cfg = T_R.get_smoke_config("grok-1-314b")
    p = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64),
             "labels": torch.zeros((1, 4), dtype=torch.int64)}
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        T_R.compute_loss(cfg, p, batch)
    logits = T_R.forward_logits(cfg, p, batch)      # inference runs
    assert logits.shape == (1, 4, 1024) and bool(torch.isfinite(
        logits[..., :cfg.vocab_size]).all())


@pytest.mark.cuda
def test_cuda_moe_router_matches_plain():
    """On the card: ids identical, gates within 1e-6, at the decode shape,
    a ragged T, kimi's E = 384, and the tie rows."""
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

"""The port's LM fleet, held against the JAX package's ``run_lm_federation``.

Both packages run the smollm-135m smoke geometry with 4 workers from the
reference's initial buffers, jax pinned to its CPU backend, the port with
``device="cpu"``.  The control plane and the token batches are the same numpy
draws, so the control fields must match bit for bit.  ``loss_global``: in f32
the two compute the same algorithm and agree to 1e-4; in bf16 the port's
attention goes through its flash kernel's plain version and the reference
through its Pallas kernel in interpret mode, activations round at other
places, and Adam steps the rounded params, so 9 rounds of training (rounds
8 and 9 train 3 and 4 rows) agree to 1e-2.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.protocol import DySTop
from repro_torch.dfl import flat_state as T_FS
from repro_torch.dfl import lm_worker as T_LW
from repro_torch.models import registry as T_R
from repro_torch.tree import tree_paths
from test_torch_resume import _one_torch_thread  # noqa: F401

CONTROL = ("rounds", "sim_time", "comm_gb", "staleness_avg", "staleness_max",
           "round_durations", "round_active")
KW = dict(n_workers=4, n_rounds=9, batch=2, seq=16, eval_every=3, seed=1)


def _mech():
    return DySTop(V=3.0, t_thre=10, max_neighbors=3)


def _cfg(dtype="bfloat16"):
    return dataclasses.replace(T_R.get_smoke_config("smollm-135m"),
                               dtype=dtype)


def _jax_cfg(dtype="bfloat16"):
    from repro.models import registry as R_R
    return dataclasses.replace(R_R.get_smoke_config("smollm-135m"),
                               dtype=dtype)


def _jax_paths(tree):
    import jax
    return [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


# --------------------------------------------------------------------------- #
# the flat fleet
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("optimizer", ["adam", "sgd", "adafactor"])
def test_fleet_layout_matches_reference(optimizer):
    """Same columns, shapes, dtypes and byte prices as the reference's
    FleetSpec, for params and optimizer state; ``from_reference`` and the
    stacked views are exact."""
    jax = pytest.importorskip("jax")
    from repro.dfl import lm_worker as R_LW
    with jax.default_device(jax.devices("cpu")[0]):
        ref = R_LW.init_fleet(_jax_cfg(), 3, optimizer=optimizer, seed=2)
        r_params, r_opt = ref.stacked_params, ref.stacked_opt
    fleet = T_LW.init_fleet(_cfg(), 3, optimizer=optimizer, device="cpu")
    for mine, theirs, tree in ((fleet.spec.params, ref.spec.params, r_params),
                               (fleet.spec.opt, ref.spec.opt, r_opt)):
        assert list(mine.keys) == _jax_paths(tree)
        assert mine.offsets == theirs.offsets and mine.sizes == theirs.sizes
        assert mine.shapes == theirs.shapes
        assert [str(d).replace("torch.", "") for d in mine.dtypes] \
            == list(theirs.dtypes)
    assert fleet.model_bytes == ref.model_bytes
    assert fleet.opt_bytes == ref.opt_bytes
    pbuf, obuf = T_FS.fleet_from_reference(np.asarray(ref.pbuf),
                                           np.asarray(ref.obuf), fleet.spec,
                                           "cpu")
    np.testing.assert_array_equal(pbuf.numpy(), np.asarray(ref.pbuf))
    np.testing.assert_array_equal(obuf.numpy(), np.asarray(ref.obuf))
    fleet.pbuf, fleet.obuf = pbuf, obuf
    for stacked, r_stacked in ((fleet.stacked_params, r_params),
                               (fleet.stacked_opt, r_opt)):
        for (_, got), want in zip(tree_paths(stacked),
                                  jax.tree.leaves(r_stacked)):
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want.astype("float32")))
    # row round trip: unravel -> ravel is bit exact, bf16 and int32 included
    for buf, fs in ((pbuf, fleet.spec.params), (obuf, fleet.spec.opt)):
        row = torch.empty_like(buf[1])
        T_FS.ravel_tree_into(T_FS.unravel_tree(buf[1], fs), fs, row)
        assert torch.equal(row, buf[1])
    # and the stacked trees flatten back to the same buffers
    again = T_FS.flatten_fleet(fleet.stacked_params, fleet.stacked_opt)
    assert torch.equal(again[0], pbuf) and torch.equal(again[1], obuf)


def test_fleet_from_reference_checks_shapes():
    fleet = T_LW.init_fleet(_cfg(), 2, device="cpu")
    p, o = fleet.pbuf.numpy(), fleet.obuf.numpy()
    with pytest.raises(ValueError, match="this fleet needs"):
        T_FS.fleet_from_reference(p[:, :-1], o, fleet.spec, "cpu")
    with pytest.raises(ValueError, match="rows"):
        T_FS.fleet_from_reference(p, o[:1], fleet.spec, "cpu")


def test_worker_streams_bit_identical():
    pytest.importorskip("jax")
    from repro.dfl import lm_worker as R_LW
    cfg = _cfg()
    for kw in (dict(), dict(skip_rounds=2), dict(noniid_offset=False)):
        mine = T_LW.worker_streams(cfg, 3, 2, 16, seed=4, **kw)
        theirs = R_LW.worker_streams(_jax_cfg(), 3, 2, 16, seed=4, **kw)
        for _ in range(3):
            a, b = next(mine), next(theirs)
            for k in ("tokens", "labels", "loss_mask"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------- #
# federation parity
# --------------------------------------------------------------------------- #


def _reference_run(dtype, backend):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.protocol import DySTop as R_DySTop
    from repro.dfl import lm_worker as R_LW
    from repro.kernels.config import KernelConfig
    with jax.default_device(jax.devices("cpu")[0]):
        init = R_LW.init_fleet(_jax_cfg(dtype), KW["n_workers"],
                               seed=KW["seed"])
        fleet, hist = R_LW.run_lm_federation(
            R_DySTop(V=3.0, t_thre=10, max_neighbors=3), _jax_cfg(dtype),
            R_LW.LMRunConfig(kernels=KernelConfig(backend=backend), **KW))
        batch = {k: v[0] for k, v in next(R_LW.worker_streams(
            _jax_cfg(dtype), 1, 3, 24, seed=9)).items()}
        alpha = np.full((KW["n_workers"],), 0.25, np.float32)
        ev = R_LW.fleet_eval(fleet, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                             jnp.asarray(alpha))
    return ((np.asarray(init.pbuf), np.asarray(init.obuf)), fleet, hist,
            (batch, alpha, ev))


@pytest.mark.parametrize("dtype, backend, tol", [
    ("float32", "reference", 1e-4), ("bfloat16", "pallas", 1e-2)])
def test_federation_matches_reference(dtype, backend, tol):
    init, r_fleet, r_hist, (batch, alpha, r_eval) = _reference_run(dtype,
                                                                   backend)
    fleet, hist = T_LW.run_lm_federation(_mech(), _cfg(dtype),
                                         T_LW.LMRunConfig(**KW),
                                         device="cpu", init=init)
    for f in CONTROL:
        assert getattr(hist, f) == getattr(r_hist, f), f
    assert max(hist.round_active) > 1       # some rounds train several rows
    np.testing.assert_allclose(hist.loss_global, r_hist.loss_global,
                               atol=tol, rtol=0)
    # Eq. 11 on another batch and weighting, from the trained buffers
    ev = T_LW.fleet_eval(fleet, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                         torch.from_numpy(alpha))
    np.testing.assert_allclose(ev, r_eval, atol=tol, rtol=0)
    if dtype == "float32":
        np.testing.assert_allclose(hist.round_loss, r_hist.round_loss,
                                   atol=1e-4, rtol=0)
        # params: all within one Adam step (lr 1e-3) — where a gradient is
        # ~0, f32 noise moves m / (sqrt(v) + eps) — and all but 1e-4 of
        # them within 1e-5
        gap = np.abs(fleet.pbuf.numpy() - np.asarray(r_fleet.pbuf))
        assert gap.max() <= 1e-3 and (gap > 1e-5).mean() < 1e-4
        gap = np.abs(fleet.obuf.numpy() - np.asarray(r_fleet.obuf))
        assert gap.max() <= 1e-3 and (gap > 1e-5).mean() < 1e-4


def _port_run(**kw):
    return T_LW.run_lm_federation(_mech(), _cfg("float32"),
                                  T_LW.LMRunConfig(**dict(KW, **kw)),
                                  device="cpu")


@pytest.mark.parametrize("kw_a, kw_b", [
    (dict(pipeline_depth=0), dict(pipeline_depth=1)),
    (dict(scan_horizon=1), dict(scan_horizon=8)),
    (dict(col_sparse_mix=False, host_batch_gather=False), dict())])
def test_dispatch_settings_do_not_change_the_run(kw_a, kw_b):
    """Pipeline depth, horizon, the mix contraction and where batches are
    gathered change how rounds reach the device, never the values."""
    fa, ha = _port_run(**kw_a)
    fb, hb = _port_run(**kw_b)
    for f in CONTROL + ("loss_global", "round_loss", "loss_local"):
        assert getattr(ha, f) == getattr(hb, f), f
    assert torch.equal(fa.pbuf, fb.pbuf) and torch.equal(fa.obuf, fb.obuf)


def test_padding_rows_stay_bit_identical():
    """A round's idle workers — padding targets included — keep their param
    and state rows exactly; the trained ones move."""
    fleet = T_LW.init_fleet(_cfg("float32"), 4, device="cpu")
    g = torch.Generator().manual_seed(0)
    fleet.pbuf += 0.01 * torch.randn(fleet.pbuf.shape, generator=g)
    p0, o0 = fleet.pbuf.clone(), fleet.obuf.clone()
    engine = T_LW.LMEngine(fleet.cfg, fleet.optimizer, fleet.spec)
    active = np.array([False, True, False, False])
    links = np.zeros((4, 4), bool)
    links[1, 3] = True
    W = np.eye(4, dtype=np.float32)
    W[1, 1], W[1, 3] = 0.5, 0.5

    class Plan:
        pass

    plan = Plan()
    plan.W, plan.active, plan.links, plan.t = W, active, links, 1
    tok = np.random.default_rng(0).integers(0, 1024, (1, 4, 2, 16),
                                            dtype=np.int32)
    from repro_torch.core.planner import bucket_key
    key = bucket_key(plan, 4, min_bucket=2)
    assert key == (2, 2)                       # one padding row each
    _, _, losses = engine.dispatch_chunk(
        fleet.pbuf, fleet.obuf, [plan], tok, tok, key=key, col_sparse=False,
        fuse=True, min_bucket=2, pregather=True)
    idle = [0, 2, 3]
    assert torch.equal(fleet.pbuf[idle], p0[idle])
    assert torch.equal(fleet.obuf[idle], o0[idle])
    assert not torch.equal(fleet.pbuf[1], p0[1])
    assert losses.shape == (1, 4) and float(losses[0, 1]) > 0
    assert torch.equal(losses[0, idle], torch.zeros(3))


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #


def test_run_lm_federation_defaults_to_the_card():
    run = T_LW.LMRunConfig(n_workers=2, n_rounds=1, batch=1, seq=8)
    assert run.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T_LW.run_lm_federation(_mech(), _cfg(), run)


@pytest.mark.parametrize("make, item", [
    (lambda: T_LW.LMRunConfig(resident_fleet=False), 4),
    (lambda: T_LW.LMRunConfig(mesh_shards=2, resident_fleet=False), 4)])
def test_lm_unported_paths_name_their_roadmap_item(make, item):
    """The settings that raised ``NotImplementedError`` naming Queue A
    ``item`` until it was ported: the per-call-flatten oracle now
    constructs and runs, and with a mesh it raises ``ValueError`` when the
    run starts, as the JAX package's does."""
    run = dataclasses.replace(make(), n_workers=2, n_rounds=2, batch=1,
                              seq=8, eval_every=2)
    if run.mesh_shards > 1:
        with pytest.raises(ValueError, match="resident engine"):
            T_LW.run_lm_federation(_mech(), _cfg(), run, device="cpu")
    else:
        fleet, hist = T_LW.run_lm_federation(_mech(), _cfg(), run,
                                             device="cpu")
        assert hist.rounds == [2] and np.isfinite(hist.loss_global).all()
        assert fleet.pbuf.shape[0] == 2


@pytest.mark.parametrize("arch, feed", [
    ("seamless-m4t-medium", "frames"), ("paligemma-3b", "prefix_embeds")])
def test_lm_fleet_refuses_the_stub_frontend_families(arch, feed):
    """The fleet's row-step feeds tokens, labels and the loss mask only (as
    the JAX package's, which fails on these families at its first row-step:
    tests/test_torch_vlm.py, tests/test_torch_encdec.py): the port refuses
    them at set-up, before any draw or allocation, naming the feed."""
    for get in (T_R.get_smoke_config, T_R.get_config):
        cfg = get(arch)
        with pytest.raises(ValueError, match=f"batch\\['{feed}'\\]"):
            T_LW.run_lm_federation(_mech(), cfg, T_LW.LMRunConfig(
                n_workers=2, n_rounds=1, batch=1, seq=8), device="cpu")


def test_use_kernel_alias_warns_and_changes_nothing():
    """The JAX package's deprecated ``use_kernel`` boolean: the tensor's
    device picks the kernel here, so it warns and the run is the same."""
    kw = dict(KW, n_rounds=3)
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        run = T_LW.LMRunConfig(use_kernel=True, **kw)
    fa, ha = T_LW.run_lm_federation(_mech(), _cfg("float32"), run,
                                    device="cpu")
    fb, hb = _port_run(n_rounds=3)
    for f in CONTROL + ("loss_global", "round_loss"):
        assert getattr(ha, f) == getattr(hb, f), f
    assert torch.equal(fa.pbuf, fb.pbuf)


def test_attention_decode_and_cross_branches_name_serving():
    """The decode-cache branch runs (serving is ported): one step writes its
    key and value rows at ``cache_pos`` in place (held against the
    reference in tests/test_torch_decode.py); the cross-attention branch
    (``kv_x``: q from x, k and v from ``kv_x``, no rope, no mask) equals
    the reference's on the same params and inputs, f32."""
    from repro_torch.models import layers as T_L
    cfg = _cfg("float32")
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    p = params["blocks"]["p0"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((1, 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    pos = torch.full((1, 1), 3, dtype=torch.int32)
    hd = cfg.resolved_head_dim
    cache = {"k": torch.zeros((1, 8, cfg.n_kv_heads, hd)),
             "v": torch.zeros((1, 8, cfg.n_kv_heads, hd))}
    y, new = T_L.multihead_attention(cfg, p, x, T_L.AttnSpec(), pos,
                                     cache=cache, cache_pos=3)
    assert y.shape == (1, 1, cfg.d_model) and new["k"] is cache["k"]
    written = cache["k"].abs().sum(dim=(0, 2, 3)) > 0
    assert written.tolist() == [i == 3 for i in range(8)]
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import layers as R_L
    from repro.models import registry as R_R
    kv = torch.randn((1, 5, cfg.d_model),
                     generator=torch.Generator().manual_seed(2))
    xq = torch.randn((1, 3, cfg.d_model),
                     generator=torch.Generator().manual_seed(3))
    q_pos = torch.arange(3, dtype=torch.int32)[None]
    got, none = T_L.multihead_attention(cfg, p, xq, T_L.AttnSpec(causal=False),
                                        q_pos, kv_x=kv)
    assert none is None and got.shape == (1, 3, cfg.d_model)
    r_cfg = dataclasses.replace(R_R.get_smoke_config(cfg.arch_id.replace(
        "-smoke", "")), dtype="float32")
    with jax.default_device(jax.devices("cpu")[0]):
        want, _ = R_L.multihead_attention(
            r_cfg, {k: jnp.asarray(v.numpy()) for k, v in p.items()},
            jnp.asarray(xq.numpy()), R_L.AttnSpec(causal=False),
            jnp.asarray(q_pos.numpy()), kv_x=jnp.asarray(kv.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(failure_prob=1.5), dict(lr=0.0), dict(seq=0),
    dict(pipeline_depth=-1), dict(checkpoint_every=-1),
    dict(checkpoint_every=3), dict(kernels="pallas"), dict(device="tpu")])
def test_lmrunconfig_rejects_out_of_range(kw):
    with pytest.raises(ValueError):
        T_LW.LMRunConfig(**kw)

"""The legacy per-leaf paths on both planes, held against the JAX package.

Simulation plane (``SimConfig(fused_engine=False)``): ``apply_mixing``,
``local_train``, ``evaluate_stacked``/``evaluate_global`` and the whole
``run_simulation`` legacy branch, and its snapshots both ways between the
packages.  Both packages draw this path's minibatches from one numpy
stream (``seed + 0x5EED``), so handed the reference's init the port trains
on the same batches: the control plane is bit-equal and the curves agree
to f32 rounding, with no batch injected.
The tolerances: ``acc_global``/``acc_local`` 2e-3 (two of 1,200 test
samples), ``loss_global`` rtol 1e-4, the final stacked params atol 1e-4;
``apply_mixing`` 1e-6 against the Pallas kernel in interpret mode; the
worker functions 1e-5.

LM plane (``LMRunConfig(resident_fleet=False)``): the ``LMFleet`` setters,
``fleet_mix_stacked``'s two branches, ``make_fleet_step`` and
``fleet_eval_stacked`` against the reference at smollm-135m's smoke
geometry in f32; the port's oracle against its resident engine for every
optimizer family (tests/test_lm_fleet.py's tolerances), and against the
JAX package's oracle (tests/test_torch_lm.py's f32 tolerances).  A mesh
with either legacy path raises ``ValueError``.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as R_CIO  # noqa: E402
from repro.core import aggregation as R_AGG  # noqa: E402
from repro.core.protocol import DySTop as R_DySTop  # noqa: E402
from repro.dfl import flat_state as R_FS  # noqa: E402
from repro.dfl import lm_worker as R_LW  # noqa: E402
from repro.dfl import simulator as R_SIM  # noqa: E402
from repro.dfl import worker as R_WK  # noqa: E402
from repro.kernels.config import KernelConfig as R_KernelConfig  # noqa: E402
from repro.models import registry as R_R  # noqa: E402
from repro_torch.checkpoint import io as CIO  # noqa: E402
from repro_torch.core import aggregation as T_AGG  # noqa: E402
from repro_torch.core.protocol import DySTop  # noqa: E402
from repro_torch.dfl import flat_state as T_FS  # noqa: E402
from repro_torch.dfl import lm_worker as T_LW  # noqa: E402
from repro_torch.dfl import simulator as T_SIM  # noqa: E402
from repro_torch.dfl import worker as T_WK  # noqa: E402
from repro_torch.models import registry as T_R  # noqa: E402
from test_torch_resume import _one_torch_thread  # noqa: E402,F401

CONTROL = ("rounds", "sim_time", "comm_gb", "round_active", "staleness_avg",
           "staleness_max", "round_durations")
SIM = dict(n_workers=16, hidden=48, n_samples=6000, phi=0.5, lr=0.1,
           fused_engine=False)
LM_CONTROL = ("rounds", "sim_time", "comm_gb", "staleness_avg",
              "staleness_max", "round_durations", "round_active")


def _np(tree):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in tree.items()}


def _sim_init(n=16, hidden=48):
    stacked = R_WK.init_stacked(jax.random.PRNGKey(0), n, 32, hidden, 10)
    return {k: np.asarray(v) for k, v in stacked.items()}


def _r_mech():
    return R_DySTop(V=10.0, t_thre=20, max_neighbors=5)


def _t_mech():
    return DySTop(V=10.0, t_thre=20, max_neighbors=5)


def _close_curves(got, ref):
    for f in CONTROL:
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("acc_global", "acc_local"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   atol=2e-3, rtol=0, err_msg=f)
    np.testing.assert_allclose(got.loss_global, ref.loss_global, rtol=1e-4)


# --------------------------------------------------------------------------- #
# the simulation plane's pieces
# --------------------------------------------------------------------------- #


def test_apply_mixing_matches_the_pallas_kernel():
    """Per leaf, dense W: a (6, 6) W over leaves of 10, 64 and 2x3x5
    columns (below one block, not multiples of 4), bf16 cast back."""
    rng = np.random.default_rng(0)
    W = rng.random((6, 6)).astype(np.float32)
    W /= W.sum(1, keepdims=True)
    tree = {"a": rng.normal(size=(6, 10)).astype(np.float32),
            "b": rng.normal(size=(6, 64)).astype(np.float32),
            "c": rng.normal(size=(6, 2, 3, 5)).astype(np.float32)}
    want = R_AGG.apply_mixing(jnp.asarray(W), {k: jnp.asarray(v) for k, v
                                              in tree.items()},
                              kernels=R_KernelConfig(backend="pallas"))
    got = T_AGG.apply_mixing(W, _np(tree))
    for k in tree:
        assert got[k].shape == tree[k].shape and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    half = T_AGG.apply_mixing(W, {"h": torch.from_numpy(tree["b"]).bfloat16()})
    assert half["h"].dtype == torch.bfloat16
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        again = T_AGG.apply_mixing(W, _np(tree), use_kernel=True)
    assert all(torch.equal(again[k], got[k]) for k in tree)


def test_worker_functions_match_reference():
    n, dim, hidden, classes = 6, 32, 48, 10
    st = R_WK.init_stacked(jax.random.PRNGKey(3), n, dim, hidden, classes,
                           same_init=False)
    rng = np.random.default_rng(1)
    xb = rng.normal(size=(n, 2, 32, dim)).astype(np.float32)
    yb = rng.integers(0, classes, (n, 2, 32)).astype(np.int32)
    active = np.array([1, 0, 1, 1, 0, 1], bool)
    r_p, r_loss = R_WK.local_train(st, jnp.asarray(xb), jnp.asarray(yb),
                                   jnp.asarray(active), lr=0.1, local_steps=2)
    t_p, t_loss = T_WK.local_train(_np(st), torch.from_numpy(xb),
                                   torch.from_numpy(yb),
                                   torch.from_numpy(active), lr=0.1,
                                   local_steps=2)
    for k in st:
        np.testing.assert_allclose(t_p[k].numpy(), np.asarray(r_p[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
        # an inactive row is w - 0 * g: its own value, bit for bit
        np.testing.assert_array_equal(t_p[k].numpy()[~active],
                                      np.asarray(st[k])[~active])
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(r_loss), atol=1e-5)
    x = rng.normal(size=(300, dim)).astype(np.float32)
    y = rng.integers(0, classes, 300).astype(np.int32)
    alpha = rng.random(n).astype(np.float32)
    alpha /= alpha.sum()
    r_st = R_WK.evaluate_stacked(r_p, jnp.asarray(x), jnp.asarray(y))
    t_st = T_WK.evaluate_stacked(t_p, torch.from_numpy(x), torch.from_numpy(y))
    r_gl = R_WK.evaluate_global(r_p, jnp.asarray(alpha), jnp.asarray(x),
                                jnp.asarray(y))
    t_gl = T_WK.evaluate_global(t_p, torch.from_numpy(alpha),
                                torch.from_numpy(x), torch.from_numpy(y))
    for got, want in ((t_st, r_st), (t_gl, r_gl)):
        np.testing.assert_allclose([float(v) for v in got],
                                   [float(v) for v in want], atol=1e-5)


# --------------------------------------------------------------------------- #
# run_simulation(fused_engine=False)
# --------------------------------------------------------------------------- #


def test_legacy_simulation_matches_reference(tmp_path):
    """60 rounds from the reference's init, no batch injected; the final
    stacked params read from both packages' round-60 snapshots."""
    kw = dict(SIM, n_rounds=60, checkpoint_every=60)
    ref = R_SIM.run_simulation(_r_mech(), R_SIM.SimConfig(
        **kw, checkpoint_dir=str(tmp_path / "ref")))
    got = T_SIM.run_simulation(_t_mech(), T_SIM.SimConfig(
        **kw, checkpoint_dir=str(tmp_path / "port")), device="cpu",
        init=_sim_init())
    _close_curves(got, ref)
    assert got.acc_global[-1] > got.acc_global[0]
    r_blobs, r_extra = CIO.read_checkpoint(tmp_path / "ref"
                                           / "ckpt_round000060.npz")
    t_blobs, t_extra = CIO.read_checkpoint(tmp_path / "port"
                                           / "ckpt_round000060.npz")
    params = sorted(k for k in r_blobs if k.startswith("params|"))
    assert params == sorted(k for k in t_blobs if k.startswith("params|"))
    assert len(params) == 6
    for k in params:
        assert t_blobs[k].shape == r_blobs[k].shape
        np.testing.assert_allclose(t_blobs[k], r_blobs[k], atol=1e-4,
                                   rtol=0, err_msg=k)
    # the batch stream's state: both consumed it alike
    assert t_extra["batch_rng"] == r_extra["batch_rng"]


def test_legacy_resumes_a_jax_package_snapshot(tmp_path):
    """The JAX package's round-20 legacy snapshot (numpy rng state with its
    128-bit integers included), continued by the port, ends on the
    reference's uninterrupted history."""
    kw = dict(SIM, n_rounds=40, checkpoint_every=10)
    ref = R_SIM.run_simulation(_r_mech(), R_SIM.SimConfig(
        **kw, checkpoint_dir=str(tmp_path / "ref")))
    snap = R_CIO.checkpoint_path(tmp_path / "ref", 20)
    state = CIO.read_checkpoint(snap, ())[1]["batch_rng"]["state"]
    assert state["state"] >= 2 ** 64 or state["inc"] >= 2 ** 64
    got = T_SIM.run_simulation(_t_mech(), T_SIM.SimConfig(
        **kw, checkpoint_dir=str(tmp_path / "port")), device="cpu",
        resume_from=str(snap))
    _close_curves(got, ref)
    n_pre = ref.rounds.index(20) + 1      # the writer's history, to the bit
    assert got.acc_global[:n_pre] == ref.acc_global[:n_pre]


def test_jax_package_resumes_a_port_legacy_snapshot(tmp_path):
    """The other way: the port's round-20 legacy snapshot, continued by the
    JAX package, ends on the port's uninterrupted history."""
    kw = dict(SIM, n_rounds=40, checkpoint_every=10)
    full = T_SIM.run_simulation(_t_mech(), T_SIM.SimConfig(
        **kw, checkpoint_dir=str(tmp_path / "port")), device="cpu",
        init=_sim_init())
    back = R_SIM.run_simulation(_r_mech(), R_SIM.SimConfig(
        **kw, checkpoint_dir=str(tmp_path / "ref")),
        resume_from=str(CIO.checkpoint_path(tmp_path / "port", 20)))
    _close_curves(back, full)


def test_legacy_snapshot_resume_is_bit_equal(tmp_path):
    kw = dict(SIM, n_rounds=40, checkpoint_every=10,
              checkpoint_dir=str(tmp_path))
    full = T_SIM.run_simulation(_t_mech(), T_SIM.SimConfig(**kw),
                                device="cpu", init=_sim_init())
    res = T_SIM.run_simulation(_t_mech(), T_SIM.SimConfig(**kw),
                               device="cpu",
                               resume_from=str(CIO.checkpoint_path(tmp_path,
                                                                   20)))
    for f in CONTROL + ("acc_global", "acc_local", "loss_global"):
        assert getattr(res, f) == getattr(full, f), f
    blobs, extra = CIO.read_checkpoint(CIO.checkpoint_path(tmp_path, 40))
    assert extra["config"]["fused_engine"] is False
    assert blobs["params|w1"].shape == (16, 32, 48)


def test_mesh_with_a_legacy_path_raises():
    with pytest.raises(ValueError, match="fused engine"):
        T_SIM.run_simulation(_t_mech(), T_SIM.SimConfig(
            n_workers=4, n_rounds=2, n_samples=400, hidden=8, mesh_shards=2,
            fused_engine=False), device="cpu")
    with pytest.raises(ValueError, match="resident engine"):
        T_LW.run_lm_federation(DySTop(), _lm_cfg(), T_LW.LMRunConfig(
            n_workers=2, n_rounds=1, batch=1, seq=8, mesh_shards=2,
            resident_fleet=False), device="cpu")


# --------------------------------------------------------------------------- #
# the LM plane's oracle
# --------------------------------------------------------------------------- #


def _lm_cfg():
    return dataclasses.replace(T_R.get_smoke_config("smollm-135m"),
                               dtype="float32")


def _r_lm_cfg():
    return dataclasses.replace(R_R.get_smoke_config("smollm-135m"),
                               dtype="float32")


def _fleets(n=3, optimizer="sgd", seed=2):
    """The reference's fleet and the port's with the same buffers."""
    ref = R_LW.init_fleet(_r_lm_cfg(), n, optimizer=optimizer, lr=1e-3,
                          seed=seed)
    fleet = T_LW.init_fleet(_lm_cfg(), n, optimizer=optimizer, lr=1e-3,
                            device="cpu")
    fleet.pbuf, fleet.obuf = T_FS.fleet_from_reference(
        np.asarray(ref.pbuf), np.asarray(ref.obuf), fleet.spec, "cpu")
    return ref, fleet


def test_fleet_setters_round_trip_bit_exact():
    ref, fleet = _fleets(optimizer="adam")
    pbuf, obuf = fleet.pbuf.clone(), fleet.obuf.clone()
    fleet.stacked_params = fleet.stacked_params
    fleet.stacked_opt = fleet.stacked_opt
    assert torch.equal(fleet.pbuf, pbuf) and torch.equal(fleet.obuf, obuf)
    ref.stacked_params = ref.stacked_params
    np.testing.assert_array_equal(fleet.pbuf.numpy(), np.asarray(ref.pbuf))
    # a bf16 fleet: the cast leaves come back exactly too
    half = T_LW.init_fleet(T_R.get_smoke_config("smollm-135m"), 2,
                           device="cpu")
    before = half.pbuf.clone()
    half.stacked_params = half.stacked_params
    assert torch.equal(half.pbuf, before)


def test_fleet_mix_stacked_both_branches_match_reference():
    ref, fleet = _fleets(n=4)
    rng = np.random.default_rng(5)
    W = rng.random((4, 4)).astype(np.float32)
    W /= W.sum(1, keepdims=True)
    active = np.array([1, 0, 1, 0], bool)
    links = np.zeros((4, 4), bool)
    links[0, 1] = links[2, 3] = True
    W[~active] = np.eye(4, dtype=np.float32)[~active]
    for args in ((), (active, links)):
        want, _ = R_FS.flatten_stacked(R_LW.fleet_mix_stacked(
            ref.stacked_params, W, *args))
        got, _ = T_FS.flatten_tree(T_LW.fleet_mix_stacked(
            fleet.stacked_params, W, *args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
        T_LW.fleet_mix(fleet, W, *args)
        np.testing.assert_array_equal(fleet.pbuf.numpy(), got.numpy())
        fleet.pbuf = T_FS.fleet_from_reference(
            np.asarray(ref.pbuf), np.asarray(ref.obuf), fleet.spec, "cpu")[0]


def test_fleet_step_and_eval_match_reference():
    """``make_fleet_step`` trains all N and masks: SGD (lr 1e-3) params and
    momentum within 1e-5, losses within 1e-5, the inactive rows' params
    and state bit for bit; ``fleet_eval_stacked`` within 1e-5."""
    ref, fleet = _fleets(n=3)
    b = next(R_LW.worker_streams(_r_lm_cfg(), 3, 2, 16, seed=4))
    active = np.array([True, False, True])
    r_p, r_o, r_loss = R_LW.make_fleet_step(ref)(
        ref.stacked_params, ref.stacked_opt,
        {k: jnp.asarray(v) for k, v in b.items()}, jnp.asarray(active))
    sp = T_FS.unflatten_tree(fleet.pbuf, fleet.spec.params, copy=True)
    so = T_FS.unflatten_tree(fleet.obuf, fleet.spec.opt, copy=True)
    t_p, t_o, t_loss = T_LW.make_fleet_step(fleet)(
        sp, so, {k: torch.from_numpy(v) for k, v in b.items()}, active)
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(r_loss), atol=1e-5,
                               rtol=0)
    for got, want, before in ((t_p, r_p, fleet.pbuf), (t_o, r_o, fleet.obuf)):
        got, want = T_FS.flatten_tree(got)[0].numpy(), np.asarray(
            R_FS.flatten_stacked(want)[0])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got[~active], before.numpy()[~active])
    alpha = np.array([0.5, 0.2, 0.3], np.float32)
    ev = next(R_LW.worker_streams(_r_lm_cfg(), 1, 2, 24, seed=9))
    ev = {k: v[0] for k, v in ev.items()}
    want = R_LW.fleet_eval_stacked(_r_lm_cfg(), r_p, {
        k: jnp.asarray(v) for k, v in ev.items()}, jnp.asarray(alpha))
    got = T_LW.fleet_eval_stacked(_lm_cfg(), t_p, {
        k: torch.from_numpy(v) for k, v in ev.items()}, torch.from_numpy(alpha))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("optimizer", ["adam", "sgd", "adafactor"])
def test_resident_matches_the_oracle(optimizer):
    """As the JAX package's test_resident_matches_reflatten_oracle: control
    plane exact, params and state within rtol 1e-4 / atol 1e-5, the eval
    curve within rtol 1e-3."""
    kw = dict(n_workers=4, n_rounds=6, batch=2, seq=16, eval_every=3, seed=1,
              optimizer=optimizer)
    cfg = T_R.get_smoke_config("smollm-135m")
    mech = lambda: DySTop(V=3.0, t_thre=10, max_neighbors=3)  # noqa: E731
    f_res, h_res = T_LW.run_lm_federation(mech(), cfg, T_LW.LMRunConfig(
        **kw), device="cpu")
    f_ora, h_ora = T_LW.run_lm_federation(mech(), cfg, T_LW.LMRunConfig(
        resident_fleet=False, **kw), device="cpu")
    for f in LM_CONTROL:
        assert getattr(h_res, f) == getattr(h_ora, f), f
    np.testing.assert_allclose(f_res.pbuf.numpy(), f_ora.pbuf.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f_res.obuf.numpy(), f_ora.obuf.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_res.loss_global, h_ora.loss_global,
                               rtol=1e-3)


def test_legacy_lm_run_matches_reference():
    """The oracle in both packages, smollm smoke in f32, 4 workers, 9
    rounds from the reference's init: tests/test_torch_lm.py's f32
    tolerances (loss_global and round_loss 1e-4; params all within one
    Adam step, all but 1e-4 of them within 1e-5)."""
    kw = dict(n_workers=4, n_rounds=9, batch=2, seq=16, eval_every=3, seed=1)
    init = R_LW.init_fleet(_r_lm_cfg(), 4, seed=1)
    r_fleet, r_hist = R_LW.run_lm_federation(
        R_DySTop(V=3.0, t_thre=10, max_neighbors=3), _r_lm_cfg(),
        R_LW.LMRunConfig(resident_fleet=False, **kw))
    fleet, hist = T_LW.run_lm_federation(
        DySTop(V=3.0, t_thre=10, max_neighbors=3), _lm_cfg(),
        T_LW.LMRunConfig(resident_fleet=False, **kw), device="cpu",
        init=(np.asarray(init.pbuf), np.asarray(init.obuf)))
    for f in LM_CONTROL:
        assert getattr(hist, f) == getattr(r_hist, f), f
    assert max(hist.round_active) > 1
    np.testing.assert_allclose(hist.loss_global, r_hist.loss_global,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(hist.round_loss, r_hist.round_loss, atol=1e-4,
                               rtol=0)
    for got, want in ((fleet.pbuf, r_fleet.pbuf), (fleet.obuf, r_fleet.obuf)):
        gap = np.abs(got.numpy() - np.asarray(want))
        assert gap.max() <= 1e-3 and (gap > 1e-5).mean() < 1e-4

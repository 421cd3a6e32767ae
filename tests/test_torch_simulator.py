"""The port's ``run_simulation`` against the JAX package's, end to end.

Handed the reference's own initial parameters, the port replays the same
control plane exactly (rounds, simulated time, comm ledger, activations,
staleness) and learns to the tolerance the JAX package already allows
between engines that draw different batch streams (tests/test_round_engine.py
``test_fused_history_matches_legacy``: acc_global within 0.1).  Within the
port, horizon and pipeline depth change nothing, and the oracle paths
(row-sparse mixing, autograd SGD) agree with the default kernels' path.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.core.protocol import DySTop as R_DySTop  # noqa: E402
from repro.dfl import simulator as R_SIM  # noqa: E402
from repro.dfl import worker as R_WK  # noqa: E402
from repro_torch.core.protocol import DySTop as T_DySTop  # noqa: E402
from repro_torch.dfl import simulator as T_SIM  # noqa: E402

CFG = dict(n_workers=16, n_rounds=40, hidden=48, n_samples=6000, phi=0.5,
           lr=0.1)
CONTROL = ("rounds", "sim_time", "comm_gb", "round_active", "staleness_avg",
           "staleness_max", "round_durations")
CURVES = ("acc_global", "acc_local", "loss_global")


def _init(n=16, dim=32, hidden=48, classes=10, seed=0):
    stacked = R_WK.init_stacked(jax.random.PRNGKey(seed), n, dim, hidden,
                                classes)
    return {k: np.asarray(v) for k, v in stacked.items()}


def _port(**kw):
    cfg = T_SIM.SimConfig(**{**CFG, **kw})
    return T_SIM.run_simulation(T_DySTop(V=10.0, t_thre=20, max_neighbors=5),
                                cfg, device="cpu", init=_init())


@pytest.fixture(scope="module")
def port_default():
    return _port()


@pytest.mark.parametrize("scenario", [None, "blackout"])
def test_history_matches_reference(port_default, scenario):
    ref = R_SIM.run_simulation(R_DySTop(V=10.0, t_thre=20, max_neighbors=5),
                               R_SIM.SimConfig(**CFG, scenario=scenario))
    got = port_default if scenario is None else _port(scenario=scenario)
    for f in CONTROL:
        assert getattr(got, f) == getattr(ref, f), f
    np.testing.assert_allclose(got.acc_global, ref.acc_global, atol=0.1)
    assert got.acc_global[-1] > got.acc_global[0]
    assert np.isfinite(got.loss_global).all()


@pytest.mark.parametrize("horizon, depth", [(1, 0), (1, 1), (8, 0), (3, 2)])
def test_horizon_and_depth_change_nothing(port_default, horizon, depth):
    got = _port(scan_horizon=horizon, pipeline_depth=depth)
    for f in CONTROL + CURVES:
        assert getattr(got, f) == getattr(port_default, f), f


@pytest.mark.parametrize("kw", [dict(col_sparse_mix=False),
                                dict(fused_local_sgd=False),
                                dict(min_bucket=2)])
def test_oracle_paths_agree(port_default, kw):
    got = _port(**kw)
    for f in CONTROL:
        assert getattr(got, f) == getattr(port_default, f), f
    # same batches: only f32 rounding differs between the lowerings
    np.testing.assert_allclose(got.acc_global, port_default.acc_global,
                               atol=0.02)
    np.testing.assert_allclose(got.loss_global, port_default.loss_global,
                               atol=1e-3)


def test_history_fields_match_reference():
    assert ([f.name for f in dataclasses.fields(T_SIM.History)]
            == [f.name for f in dataclasses.fields(R_SIM.History)])
    ref_fields = {f.name for f in dataclasses.fields(R_SIM.SimConfig)}
    port_fields = {f.name for f in dataclasses.fields(T_SIM.SimConfig)}
    assert port_fields - ref_fields == {"device"}
    assert ref_fields - port_fields == set()


def test_init_shape_is_checked():
    with pytest.raises(ValueError, match="init has"):
        T_SIM.run_simulation(T_DySTop(), T_SIM.SimConfig(**CFG),
                             device="cpu", init=_init(hidden=24))


def test_max_sim_time_and_target_accuracy():
    kw = dict(max_sim_time=30.0, n_rounds=200, target_accuracy=0.05)
    ref = R_SIM.run_simulation(R_DySTop(V=10.0, t_thre=20, max_neighbors=5),
                               R_SIM.SimConfig(**{**CFG, **kw}))
    got = _port(**kw)
    for f in CONTROL:
        assert getattr(got, f) == getattr(ref, f), f
    assert got.sim_time[-1] >= 30.0 > got.sim_time[-2]
    # every eval clears 0.05, so the first one completes the run
    assert got.completion_time == got.sim_time[0]
    assert got.completion_comm_gb == got.comm_gb[0]

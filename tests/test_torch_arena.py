"""The Table-I baselines through the port's ``run_simulation`` against the
JAX package's, end to end (the arena's apples-to-apples preconditions,
tests/test_arena.py, on the port).

Handed the reference's initial parameters, each baseline replays the
reference's control plane exactly and learns to the tolerance
tests/test_torch_simulator.py holds DySTop to (``acc_global`` within 0.1:
the two packages draw different batch streams).  Within the port the
histories, control plane and curves alike, are the same at scan_horizon 1
and 8 for every baseline.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.core import baselines as R_BL  # noqa: E402
from repro.dfl import simulator as R_SIM  # noqa: E402
from repro.dfl import worker as R_WK  # noqa: E402
from repro_torch.core import baselines as T_BL  # noqa: E402
from repro_torch.dfl import simulator as T_SIM  # noqa: E402
from test_torch_resume import _one_torch_thread  # noqa: E402,F401

CFG = dict(n_workers=16, n_rounds=40, hidden=48, n_samples=6000, phi=0.5,
           lr=0.1, eval_every=10)
CONTROL = ("rounds", "sim_time", "comm_gb", "round_active", "staleness_avg",
           "staleness_max", "round_durations")
CURVES = ("acc_global", "acc_local", "loss_global")
KW = {"matcha": {}, "gossipfl": {}, "asydfl": {"n_neighbors": 3},
      "sa-adfl": {"V": 10.0}}


def _init(n=16, dim=32, hidden=48, classes=10, seed=0):
    stacked = R_WK.init_stacked(jax.random.PRNGKey(seed), n, dim, hidden,
                                classes)
    return {k: np.asarray(v) for k, v in stacked.items()}


@pytest.mark.parametrize("name", sorted(KW))
def test_run_simulation_matches_reference(name):
    # the reference one round per dispatch (fewer shapes to compile), the
    # port at the default horizon: neither changes a trajectory
    ref = R_SIM.run_simulation(R_BL.get_mechanism(name, **KW[name]),
                               R_SIM.SimConfig(scan_horizon=1, **CFG))
    got = T_SIM.run_simulation(T_BL.get_mechanism(name, **KW[name]),
                               T_SIM.SimConfig(**CFG), device="cpu",
                               init=_init())
    for f in CONTROL:
        assert getattr(got, f) == getattr(ref, f), f
    np.testing.assert_allclose(got.acc_global, ref.acc_global, atol=0.1)
    assert np.isfinite(got.loss_global).all()
    assert got.acc_global[-1] > got.acc_global[0]


@pytest.mark.parametrize("name", sorted(KW))
def test_scan_horizon_invariance_per_baseline(name):
    h1 = T_SIM.run_simulation(T_BL.get_mechanism(name, **KW[name]),
                              T_SIM.SimConfig(**dict(CFG, scan_horizon=1)),
                              device="cpu")
    h8 = T_SIM.run_simulation(T_BL.get_mechanism(name, **KW[name]),
                              T_SIM.SimConfig(**dict(CFG, scan_horizon=8)),
                              device="cpu")
    for f in CONTROL + CURVES:
        assert getattr(h1, f) == getattr(h8, f), f

"""Snapshots and resume on the port's simulation plane.

Mirrors the resume cases of tests/test_scenarios.py and
tests/test_pipeline.py on the port: a run resumed from a snapshot of a
``checkpoint_every`` run (lockstep and at pipeline depth 1) finishes on the
uninterrupted run's control plane exactly, with the learning curve within
the reference's own tolerance (rtol 1e-6, atol 1e-7); a config mismatch, an
empty directory and a bound log together with ``resume_from`` raise.  The
snapshots cross between the packages: a snapshot the JAX package writes
resumes in the port, and one the port writes resumes in the JAX package,
each finishing on the writer's control plane (the packages draw different
batch streams, so the curves agree to tests/test_torch_simulator.py's 0.1).
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import io as CIO
from repro_torch.core.protocol import DySTop
from repro_torch.dfl.simulator import SimConfig, run_simulation

CONTROL = ("rounds", "sim_time", "comm_gb", "round_active", "round_durations",
           "staleness_avg", "staleness_max")
CURVES = ("acc_global", "acc_local", "loss_global")
BASE = dict(n_workers=12, n_rounds=20, hidden=16, n_samples=2000, phi=0.5,
            lr=0.1, eval_every=5, scenario="churn20")


@contextlib.contextmanager
def one_torch_thread():
    """One intra-op thread for these tiny CPU runs: under ``pytest -n 6``
    six processes each spinning eight OpenMP threads on small ops run
    orders of magnitude slower (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _mech():
    return DySTop(V=10.0, t_thre=8, max_neighbors=4)


def _cfg(**kw):
    return SimConfig(**dict(BASE, **kw))


def _same_run(ref, got):
    for f in CONTROL:
        assert getattr(got, f) == getattr(ref, f), f
    for f in CURVES:
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    assert got.completion_time == ref.completion_time


@pytest.mark.parametrize("depth, which", [(0, 0), (1, 1)])
def test_sim_resume_matches_uninterrupted(tmp_path, depth, which):
    ref = run_simulation(_mech(), _cfg(pipeline_depth=depth), device="cpu")
    ck = _cfg(pipeline_depth=depth, checkpoint_every=5,
              checkpoint_dir=str(tmp_path), target_accuracy=0.2)
    full = run_simulation(_mech(), ck, device="cpu")
    snaps = CIO.list_checkpoints(tmp_path)
    assert [p.name for p in snaps] == [f"ckpt_round{t:06d}.npz"
                                       for t in (10, 15, 20)]   # keep 3
    res = run_simulation(_mech(), ck, device="cpu",
                         resume_from=str(snaps[which]))
    _same_run(ref, full)
    _same_run(full, res)
    blobs, extra = CIO.read_checkpoint(snaps[which])
    assert extra["round"] == (10, 15)[which]
    assert blobs["params|buf"].dtype == np.float32
    assert blobs["params|buf"].shape[0] == BASE["n_workers"]
    assert blobs["opt|tau"].dtype == np.int64


def test_resume_rejects_config_mismatch(tmp_path):
    run_simulation(_mech(), _cfg(checkpoint_every=10,
                                 checkpoint_dir=str(tmp_path)), device="cpu")
    for kw in (dict(seed=99), dict(scenario="blackout")):
        other = _cfg(checkpoint_every=10, checkpoint_dir=str(tmp_path), **kw)
        with pytest.raises(ValueError, match="resume config mismatch"):
            run_simulation(_mech(), other, device="cpu",
                           resume_from=str(tmp_path))


def test_resume_from_empty_dir_is_actionable(tmp_path):
    with pytest.raises(FileNotFoundError, match="no"):
        run_simulation(_mech(), _cfg(), device="cpu",
                       resume_from=str(tmp_path))


def test_resume_cannot_record_a_bound_log(tmp_path):
    with pytest.raises(ValueError, match="bound log"):
        run_simulation(_mech(), _cfg(), record_history_for_bound=True,
                       device="cpu", resume_from=str(tmp_path))


def test_snapshots_cross_between_packages(tmp_path):
    jax = pytest.importorskip("jax")
    from repro.core.protocol import DySTop as R_DySTop
    from repro.dfl import simulator as R_SIM
    from repro.dfl import worker as R_WK
    r_dir, t_dir = tmp_path / "ref", tmp_path / "port"
    r_mech = lambda: R_DySTop(V=10.0, t_thre=8, max_neighbors=4)  # noqa
    r_ref = R_SIM.run_simulation(r_mech(), R_SIM.SimConfig(
        **BASE, scan_horizon=1, checkpoint_every=10,
        checkpoint_dir=str(r_dir)))
    stacked = R_WK.init_stacked(jax.random.PRNGKey(0), 12, 32, 16, 10)
    init = {k: np.asarray(v) for k, v in stacked.items()}
    t_ref = run_simulation(_mech(), _cfg(checkpoint_every=10,
                                         checkpoint_dir=str(t_dir)),
                           device="cpu", init=init)
    for f in CONTROL:
        assert getattr(t_ref, f) == getattr(r_ref, f), f
    # the JAX package's round-10 snapshot, continued by the port
    got = run_simulation(_mech(), _cfg(checkpoint_every=10,
                                       checkpoint_dir=str(tmp_path / "a")),
                         device="cpu",
                         resume_from=str(CIO.checkpoint_path(r_dir, 10)))
    # the port's round-10 snapshot, continued by the JAX package
    back = R_SIM.run_simulation(
        r_mech(), R_SIM.SimConfig(**BASE, scan_horizon=1, checkpoint_every=10,
                                  checkpoint_dir=str(tmp_path / "b")),
        resume_from=str(CIO.checkpoint_path(t_dir, 10)))
    for f in CONTROL:
        assert getattr(got, f) == getattr(r_ref, f), f
        assert getattr(back, f) == getattr(t_ref, f), f
    # the history before round 10 is the writer's own, to the bit
    n_pre = r_ref.rounds.index(10) + 1
    assert got.acc_global[:n_pre] == r_ref.acc_global[:n_pre]
    assert back.acc_global[:n_pre] == t_ref.acc_global[:n_pre]
    np.testing.assert_allclose(got.acc_global, r_ref.acc_global, atol=0.1)
    np.testing.assert_allclose(back.acc_global, t_ref.acc_global, atol=0.1)

"""The port's host control plane is bit-identical to the JAX package's.

Data synthesis, the Dirichlet partition, the edge network and the compute
times consume the numpy rng exactly as the reference does, and the horizon
planner replays the same DySTop rounds (activation, links, W, durations,
comm ledger, column unions) under every fault scenario preset.  Mirrors the
DySTop planner cases of tests/test_planner.py and tests/test_scenarios.py.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import planner as R_PL  # noqa: E402
from repro.core import protocol as R_PR  # noqa: E402
from repro.core import scenarios as R_SC  # noqa: E402
from repro.data import partition as R_PA  # noqa: E402
from repro.data import synthetic as R_SY  # noqa: E402
from repro.dfl import network as R_NW  # noqa: E402
from repro_torch.core import planner as T_PL  # noqa: E402
from repro_torch.core import protocol as T_PR  # noqa: E402
from repro_torch.core import scenarios as T_SC  # noqa: E402
from repro_torch.data import partition as T_PA  # noqa: E402
from repro_torch.data import synthetic as T_SY  # noqa: E402
from repro_torch.dfl import network as T_NW  # noqa: E402

N, ROUNDS = 16, 40


def _env(SY, PA, NW, seed, phi):
    rng = np.random.default_rng(seed)
    full = SY.make_classification(2000, 16, seed=seed)
    data, test = SY.train_test_split(full, 0.2, seed=seed)
    parts, class_counts = PA.dirichlet_partition(data, N, phi, seed=seed)
    net = NW.EdgeNetwork(NW.NetworkConfig(n_workers=N), rng)
    h_i = NW.heterogeneous_compute_times(N, 1.0, rng, sigma=0.75)
    model_bytes = 27000.0
    return dict(data=data, test=test, parts=parts, class_counts=class_counts,
                net=net, h_i=h_i, rng=rng, model_bytes=model_bytes,
                exp_link_time=net.expected_link_time(model_bytes))


def _planner(PL, PR, SC, env, scenario, failure_prob):
    comp = SC.resolve_scenario(scenario, N, ROUNDS, dist=env["net"].dist,
                               comm_range_m=env["net"].cfg.comm_range_m)
    sizes = np.array([len(p) for p in env["parts"]], np.float64)
    return PL.HorizonPlanner(
        PR.DySTop(V=10.0, t_thre=8, max_neighbors=4), h_i=env["h_i"],
        in_range=env["net"].in_range(), exp_link_time=env["exp_link_time"],
        model_bytes=env["model_bytes"], class_counts=env["class_counts"],
        data_sizes=sizes, net=env["net"], rng=env["rng"], tau_bound=5,
        bandwidth_budget=8.0, link_timeout_s=5.0, sync_link_timeout_s=30.0,
        failure_prob=failure_prob, failure_persist=0.5, scenario=comp)


@pytest.mark.parametrize("seed, phi", [(0, 0.5), (3, 1.0)])
def test_data_and_network_bit_identical(seed, phi):
    r = _env(R_SY, R_PA, R_NW, seed, phi)
    t = _env(T_SY, T_PA, T_NW, seed, phi)
    for split in ("data", "test"):
        np.testing.assert_array_equal(r[split].x, t[split].x)
        np.testing.assert_array_equal(r[split].y, t[split].y)
        assert r[split].n_classes == t[split].n_classes
    assert len(r["parts"]) == len(t["parts"])
    for a, b in zip(r["parts"], t["parts"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(r["class_counts"], t["class_counts"])
    for f in ("pos", "dist", "tx_power_w"):
        np.testing.assert_array_equal(getattr(r["net"], f),
                                      getattr(t["net"], f))
    np.testing.assert_array_equal(r["net"].in_range(), t["net"].in_range())
    np.testing.assert_array_equal(r["h_i"], t["h_i"])
    np.testing.assert_array_equal(r["exp_link_time"], t["exp_link_time"])
    # the shared stream stands at the same position afterwards
    assert r["rng"].bit_generator.state == t["rng"].bit_generator.state


@pytest.mark.parametrize("scenario, failure_prob", [
    (None, 0.0), (None, 0.2), ("churn20", 0.0), ("blackout", 0.0),
    ("straggler_tail", 0.0), ("mobile", 0.1)])
def test_planner_trajectory_bit_identical(scenario, failure_prob):
    r_env = _env(R_SY, R_PA, R_NW, 1, 0.5)
    t_env = _env(T_SY, T_PA, T_NW, 1, 0.5)
    r_pl = _planner(R_PL, R_PR, R_SC, r_env, scenario, failure_prob)
    t_pl = _planner(T_PL, T_PR, T_SC, t_env, scenario, failure_prob)
    for _ in range(ROUNDS):
        a, b = r_pl.plan_round(), t_pl.plan_round()
        assert a.t == b.t and a.synchronous == b.synchronous
        for f in ("active", "links", "W", "mix_cols", "mix_rows",
                  "train_rows", "mix_pad", "train_pad"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"round {a.t}: {f}")
        assert a.duration == b.duration and a.n_transfers == b.n_transfers
        for col in (False, True):
            assert (R_PL.bucket_key(a, N, col_sparse=col)
                    == T_PL.bucket_key(b, N, col_sparse=col))
        assert R_PL.mix_is_train(a) == T_PL.mix_is_train(b)
        assert r_pl.comm_bytes == t_pl.comm_bytes
        assert r_pl.sim_clock == t_pl.sim_clock
        np.testing.assert_array_equal(r_pl.st.tau, t_pl.st.tau)
        np.testing.assert_array_equal(r_pl.st.queue, t_pl.st.queue)
    assert r_env["rng"].bit_generator.state == t_env["rng"].bit_generator.state


def test_chunk_spans_match():
    r_env = _env(R_SY, R_PA, R_NW, 2, 0.5)
    t_env = _env(T_SY, T_PA, T_NW, 2, 0.5)
    r_plans = _planner(R_PL, R_PR, R_SC, r_env, None, 0.1).plan(ROUNDS)
    t_plans = _planner(T_PL, T_PR, T_SC, t_env, None, 0.1).plan(ROUNDS)
    for col in (False, True):
        assert (list(R_PL.chunk_spans(r_plans, N, col_sparse=col))
                == list(T_PL.chunk_spans(t_plans, N, col_sparse=col)))


@pytest.mark.parametrize("preset", R_SC.SCENARIO_PRESETS)
def test_scenario_presets_match(preset):
    a = R_SC.get_scenario(preset, 20, 60)
    b = T_SC.get_scenario(preset, 20, 60)
    assert repr(a.events) == repr(b.events) and a.name == b.name

"""The port's Table-I baselines (``repro_torch.core.baselines``) against the
JAX package's, on the host control plane.

Each of the five mechanisms, driven by the port's ``HorizonPlanner``, must
plan the reference's rounds bit for bit (activations, links, W, durations,
the comm ledger, staleness and the rng stream's position), with and without
worker failures.  Also mirrors the rest of tests/test_arena.py on the port:
the Eq. 10 ledger, plans unchanged by ``mesh_shards``, SA-ADFL's singleton
drift-plus-penalty activation, MATCHA's base-graph decomposition and its
identity-keyed cache, and ``get_mechanism``'s table.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import baselines as R_BL  # noqa: E402
from repro.core import planner as R_PL  # noqa: E402
from repro.core import protocol as R_PR  # noqa: E402
from repro.data import partition as R_PA  # noqa: E402
from repro.data import synthetic as R_SY  # noqa: E402
from repro.dfl import network as R_NW  # noqa: E402
from repro_torch.core import baselines as T_BL  # noqa: E402
from repro_torch.core import planner as T_PL  # noqa: E402
from repro_torch.core import protocol as T_PR  # noqa: E402
from repro_torch.core.staleness import StalenessState  # noqa: E402
from repro_torch.data import partition as T_PA  # noqa: E402
from repro_torch.data import synthetic as T_SY  # noqa: E402
from repro_torch.dfl import network as T_NW  # noqa: E402

N, ROUNDS = 16, 64
REF = (R_BL, R_PR, R_PL, R_SY, R_PA, R_NW)
PORT = (T_BL, T_PR, T_PL, T_SY, T_PA, T_NW)


def _mech(name, BL, PR):
    return {"matcha": lambda: BL.MATCHA(activation_ratio=0.5, seed=0),
            "gossipfl": lambda: BL.GossipFL(),
            "asydfl": lambda: BL.AsyDFL(n_neighbors=3),
            "sa-adfl": lambda: BL.SAADFL(V=10.0),
            "dystop": lambda: PR.DySTop(V=10.0, t_thre=6,
                                        max_neighbors=4)}[name]()


NAMES = ("dystop", "matcha", "gossipfl", "asydfl", "sa-adfl")


def _env(SY, PA, NW, n=N, seed=0, phi=0.5):
    """tests/test_planner.py's planner environment, on either package."""
    rng = np.random.default_rng(seed)
    full = SY.make_classification(2000, 16, seed=seed)
    data, _ = SY.train_test_split(full, 0.2, seed=seed)
    parts, class_counts = PA.dirichlet_partition(data, n, phi, seed=seed)
    net = NW.EdgeNetwork(NW.NetworkConfig(n_workers=n), rng)
    h_i = NW.heterogeneous_compute_times(n, 1.0, rng, sigma=0.75)
    model_bytes = 27000.0
    return dict(h_i=h_i, in_range=net.in_range(),
                exp_link_time=net.expected_link_time(model_bytes),
                model_bytes=model_bytes, class_counts=class_counts,
                data_sizes=np.array([len(p) for p in parts], np.float64),
                net=net, rng=rng)


def _planner(pkg, name, seed=0, n=N, **kw):
    BL, PR, PL, SY, PA, NW = pkg
    env = _env(SY, PA, NW, n=n, seed=seed)
    pl = PL.HorizonPlanner(_mech(name, BL, PR), tau_bound=5,
                           bandwidth_budget=8.0, link_timeout_s=5.0,
                           sync_link_timeout_s=30.0, **env, **kw)
    return pl, env


@pytest.mark.parametrize("failure_prob", [0.0, 0.2])
@pytest.mark.parametrize("name", NAMES)
def test_planner_trajectory_bit_identical(name, failure_prob):
    kw = dict(failure_prob=failure_prob, failure_persist=0.5)
    r_pl, r_env = _planner(REF, name, seed=4, **kw)
    t_pl, t_env = _planner(PORT, name, seed=4, **kw)
    n_sync = 0
    for _ in range(ROUNDS):
        a, b = r_pl.plan_round(), t_pl.plan_round()
        assert a.t == b.t and a.synchronous == b.synchronous
        n_sync += b.synchronous
        for f in ("active", "links", "W", "mix_cols", "mix_rows",
                  "train_rows", "mix_pad", "train_pad"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"round {a.t}: {f}")
        assert a.duration == b.duration and a.n_transfers == b.n_transfers
        assert R_PL.bucket_key(a, N, col_sparse=True) \
            == T_PL.bucket_key(b, N, col_sparse=True)
        assert R_PL.mix_is_train(a) == T_PL.mix_is_train(b)
        assert r_pl.comm_bytes == t_pl.comm_bytes
        assert r_pl.sim_clock == t_pl.sim_clock
        np.testing.assert_array_equal(r_pl.st.tau, t_pl.st.tau)
        np.testing.assert_array_equal(r_pl.st.queue, t_pl.st.queue)
        np.testing.assert_array_equal(r_pl.down, t_pl.down)
    assert n_sync == (ROUNDS if name in ("matcha", "gossipfl") else 0)
    assert r_env["rng"].bit_generator.state == t_env["rng"].bit_generator.state


@pytest.mark.parametrize("name", NAMES)
def test_comm_bytes_is_transfers_times_model_bytes(name):
    pl, env = _planner(PORT, name, seed=2, n=24)
    plans = pl.plan(30)
    assert any(p.n_transfers > 0 for p in plans)
    assert pl.comm_bytes == pytest.approx(
        sum(p.n_transfers for p in plans) * env["model_bytes"], rel=0, abs=0)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_shards_does_not_change_plans(name):
    a = _planner(PORT, name, seed=5, n=24)[0].plan(20)
    b = _planner(PORT, name, seed=5, n=24, mesh_shards=2)[0].plan(20)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p.active, q.active)
        np.testing.assert_array_equal(p.links, q.links)
        np.testing.assert_array_equal(p.W, q.W)
        assert p.duration == q.duration


def _ctx(env, n, *, tau=None, queue=None, in_range=None, base_in_range=None,
         cost=None):
    st = StalenessState.create(n, 5)
    if tau is not None:
        st.tau = np.asarray(tau, np.float64)
    if queue is not None:
        st.queue = np.asarray(queue, np.float64)
    return T_PR.RoundContext(
        t=1, round_cost=(env["h_i"] if cost is None else cost),
        readiness=env["h_i"],
        in_range=(env["in_range"] if in_range is None else in_range),
        class_counts=env["class_counts"], phys_dist=env["net"].dist,
        pull_counts=np.zeros((n, n)), staleness=st,
        bandwidth_budget=np.full(n, 8.0), data_sizes=env["data_sizes"],
        rng=np.random.default_rng(0), base_in_range=base_in_range)


def test_saadfl_picks_max_staleness_pressure():
    n = 8
    env = _env(T_SY, T_PA, T_NW, n=n, seed=0)
    cost = np.arange(1.0, n + 1.0)          # worker 0 is cheapest
    queue = np.zeros(n)
    queue[5] = 100.0                        # worker 5 is badly starved
    tau = np.zeros(n)
    tau[5] = 9.0
    dec = T_BL.SAADFL(V=10.0).round(_ctx(env, n, queue=queue, tau=tau,
                                         cost=cost))
    assert dec.active[5]
    dec = T_BL.SAADFL(V=10.0).round(_ctx(env, n, cost=cost))
    assert dec.active[0]
    # receivers mix and train: mix rows == active rows
    np.testing.assert_array_equal(dec.active, dec.active | dec.links.any(1))


def test_saadfl_activation_covers_the_whole_fleet():
    pl, _ = _planner(PORT, "sa-adfl", seed=1)
    ever_active = np.zeros(N, bool)
    max_tau = 0.0
    for _ in range(300):
        (p,) = pl.plan(1)
        ever_active |= p.active
        max_tau = max(max_tau, pl.st.tau.max())
    assert ever_active.all()
    assert max_tau < 100


def test_matcha_decomposes_base_graph_not_masked_view():
    env = _env(T_SY, T_PA, T_NW, seed=3)
    base = env["in_range"]
    masked = base.copy()
    masked[0, :] = masked[:, 0] = False      # worker 0 down this round
    m = T_BL.MATCHA(activation_ratio=1.0, seed=0)
    dec = m.round(_ctx(env, N, in_range=masked, base_in_range=base))
    union = np.zeros_like(base)
    for mat in m._matchings:
        union |= mat
    np.testing.assert_array_equal(union, base)
    np.testing.assert_array_equal(dec.links, union)
    # the same matchings as the reference's decomposition
    r_m = R_BL.MATCHA(activation_ratio=1.0, seed=0)
    r_m.round(_ctx(env, N, in_range=masked, base_in_range=base))
    assert len(r_m._matchings) == len(m._matchings)
    for a, b in zip(r_m._matchings, m._matchings):
        np.testing.assert_array_equal(a, b)


def test_matcha_cache_rederives_on_new_environment():
    m = _mech("matcha", T_BL, T_PR)
    env_a = _env(T_SY, T_PA, T_NW, seed=3)
    env_b = _env(T_SY, T_PA, T_NW, seed=7)
    m.round(_ctx(env_a, N, base_in_range=env_a["in_range"]))
    first = m._matchings
    m.round(_ctx(env_a, N, base_in_range=env_a["in_range"]))
    assert m._matchings is first
    m.round(_ctx(env_b, N, base_in_range=env_b["in_range"]))
    union = np.zeros_like(env_b["in_range"])
    for mat in m._matchings:
        union |= mat
    np.testing.assert_array_equal(union, env_b["in_range"])


def test_get_mechanism_table():
    for name, cls in [("dystop", T_PR.DySTop), ("matcha", T_BL.MATCHA),
                      ("gossipfl", T_BL.GossipFL), ("asydfl", T_BL.AsyDFL),
                      ("sa-adfl", T_BL.SAADFL)]:
        assert isinstance(T_BL.get_mechanism(name), cls)
        assert (type(R_BL.get_mechanism(name)).__name__
                == type(T_BL.get_mechanism(name)).__name__)
    assert T_BL.get_mechanism("asydfl", n_neighbors=2).s == 2
    assert T_BL.get_mechanism("dystop", V=3.0, t_thre=9).t_thre == 9
    with pytest.raises(KeyError, match="fedavg"):
        T_BL.get_mechanism("fedavg")

"""The port's Theorem 1 evaluator (``repro_torch.core.convergence``) against
the JAX package's.

The four cases of tests/test_core.py (Corollaries 1-3; the bound finite and
positive) on the port, and the bound the port computes over its own
``run_simulation(record_history_for_bound=True)`` log equal, to the last
bit, to the reference's bound over the reference's log: the log is control
plane only, so DySTop and a baseline must record the same activations and
mixing matrices in both packages.
"""
import numpy as np
import pytest

from repro_torch.core import convergence as CV
from repro_torch.core.aggregation import mixing_matrix
from test_torch_resume import _one_torch_thread  # noqa: F401

BOUND_KW = dict(f0_gap=2.0, eta=0.01, mu=0.5, L=1.0)


def _toy_history(n=4, T=30, freq=0.5, seed=0):
    rng = np.random.default_rng(seed)
    active_hist, mix_hist = [], []
    for _ in range(T):
        a = rng.random(n) < freq
        if not a.any():
            a[rng.integers(n)] = True
        links = np.zeros((n, n), bool)
        for i in np.flatnonzero(a):
            links[i] = rng.random(n) < 0.5
            links[i, i] = False
        mix_hist.append(mixing_matrix(a, links, np.ones(n)))
        active_hist.append(a)
    return active_hist, mix_hist


def test_corollary1_bound_decreases_with_tau_max():
    vals = CV.bound_vs_tau_max([1, 3, 5, 10], psi=0.5, T=100, rho=0.95,
                               f0_gap=1.0)
    assert all(vals[i] < vals[i + 1] for i in range(len(vals) - 1))


def test_corollary2_bound_decreases_with_psi():
    vals = CV.bound_vs_psi([0.1, 0.3, 0.6, 0.9], tau_max=3, T=100, rho=0.95,
                           f0_gap=1.0)
    assert all(vals[i] > vals[i + 1] for i in range(len(vals) - 1))


def test_corollary3_bound_increases_with_non_iid():
    active_hist, mix_hist = _toy_history()
    kw = dict(alpha=np.full(4, 0.25), f0_gap=1.0, eta=0.01, mu=0.5, L=1.0,
              g_star=np.ones(4))
    b_iid = CV.convergence_bound(active_hist, mix_hist, xi=np.zeros(4), **kw)
    b_noniid = CV.convergence_bound(active_hist, mix_hist,
                                    xi=np.full(4, 2.0), **kw)
    assert b_noniid > b_iid


def test_bound_finite_and_positive():
    active_hist, mix_hist = _toy_history(T=50)
    b = CV.convergence_bound(active_hist, mix_hist, alpha=np.full(4, 0.25),
                             xi=np.full(4, 0.5), g_star=np.ones(4),
                             **BOUND_KW)
    assert np.isfinite(b) and b > 0


def test_functions_equal_reference_bit_for_bit():
    pytest.importorskip("jax")
    from repro.core import convergence as R_CV
    active_hist, mix_hist = _toy_history(T=50, seed=3)
    kw = dict(alpha=np.full(4, 0.25), xi=np.linspace(0.1, 2.0, 4),
              g_star=np.arange(1.0, 5.0), **BOUND_KW)
    assert (CV.convergence_bound(active_hist, mix_hist, **kw)
            == R_CV.convergence_bound(active_hist, mix_hist, **kw))
    np.testing.assert_array_equal(
        CV.lemma1_delta(0.01, 1.0, kw["xi"], kw["g_star"]),
        R_CV.lemma1_delta(0.01, 1.0, kw["xi"], kw["g_star"]))
    assert (CV.bound_vs_tau_max([1, 4, 9], 0.4, 80, 0.97, 1.5)
            == R_CV.bound_vs_tau_max([1, 4, 9], 0.4, 80, 0.97, 1.5))
    assert (CV.bound_vs_psi([0.2, 0.7], 3, 80, 0.97, 1.5)
            == R_CV.bound_vs_psi([0.2, 0.7], 3, 80, 0.97, 1.5))


@pytest.mark.parametrize("name", ["dystop", "asydfl"])
def test_bound_over_bound_log_equals_reference(name):
    pytest.importorskip("jax")
    from repro.core.baselines import get_mechanism as r_get
    from repro.dfl import simulator as R_SIM
    from repro_torch.core.baselines import get_mechanism as t_get
    from repro_torch.dfl import simulator as T_SIM
    cfg = dict(n_workers=12, n_rounds=30, hidden=16, n_samples=3000,
               phi=0.5, eval_every=10)
    kw = ({"V": 10.0, "t_thre": 8, "max_neighbors": 4} if name == "dystop"
          else {"n_neighbors": 3})
    ref = R_SIM.run_simulation(r_get(name, **kw),
                               R_SIM.SimConfig(scan_horizon=1, **cfg),
                               record_history_for_bound=True)
    got = T_SIM.run_simulation(t_get(name, **kw), T_SIM.SimConfig(**cfg),
                               record_history_for_bound=True, device="cpu")
    for key in ("active", "W"):
        assert len(got.bound_log[key]) == len(ref.bound_log[key]) == 30
        for a, b in zip(got.bound_log[key], ref.bound_log[key]):
            np.testing.assert_array_equal(a, b)
    from repro.core import convergence as R_CV
    n = cfg["n_workers"]
    alpha = np.full(n, 1.0 / n)
    args = dict(alpha=alpha, xi=np.full(n, 0.5), g_star=np.ones(n),
                **BOUND_KW)
    b_port = CV.convergence_bound(got.bound_log["active"],
                                  got.bound_log["W"], **args)
    b_ref = R_CV.convergence_bound(ref.bound_log["active"],
                                   ref.bound_log["W"], **args)
    assert np.isfinite(b_port) and b_port > 0
    assert b_port == b_ref

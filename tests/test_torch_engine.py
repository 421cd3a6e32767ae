"""The port's round engine against the JAX package's, on the reference's own
minibatches.

From one planned horizon of DySTop rounds, identical (buf, w_rows, ctrl)
and the batches the JAX engine draws itself (``sample_batches_device``,
keyed as its ``mega_round_step`` keys them), the port's ``_mix_train_body``
matches the reference's round by round to atol 1e-5, and its H-round
``mega_round_step`` matches the reference's ``lax.scan`` to atol 1e-4 after
H = 8 rounds (f32 sums run in another order, and the differences compound
over rounds).  Column-sparse on and off, fused SGD on and off, and the
``mix_is_train`` feed are all covered; the packers are bit-identical.
Mirrors tests/test_round_engine.py and tests/test_sparse_mix.py.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import planner as R_PL  # noqa: E402
from repro.core.protocol import DySTop  # noqa: E402
from repro.data.partition import dirichlet_partition  # noqa: E402
from repro.data.synthetic import make_classification  # noqa: E402
from repro.dfl import flat_state as R_FS  # noqa: E402
from repro.dfl import worker as R_WK  # noqa: E402
from repro.dfl.network import (EdgeNetwork, NetworkConfig,  # noqa: E402
                               heterogeneous_compute_times)
from repro_torch.dfl import flat_state as T_FS  # noqa: E402
from repro_torch.dfl import worker as T_WK  # noqa: E402

N, H, STEPS, BATCH, LR = 16, 8, 2, 8, 0.1
DIM, HIDDEN = 8, 12


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    data = make_classification(1200, DIM, seed=0)
    parts, class_counts = dirichlet_partition(data, N, 0.5, seed=0)
    sizes = np.array([len(p) for p in parts], np.float64)
    net = EdgeNetwork(NetworkConfig(n_workers=N), rng)
    h_i = heterogeneous_compute_times(N, 1.0, rng, sigma=0.75)
    planner = R_PL.HorizonPlanner(
        DySTop(V=10.0, t_thre=4, max_neighbors=4), h_i=h_i,
        in_range=net.in_range(), exp_link_time=net.expected_link_time(3e4),
        model_bytes=3e4, class_counts=class_counts, data_sizes=sizes,
        net=net, rng=rng, tau_bound=5, bandwidth_budget=8.0,
        link_timeout_s=5.0, sync_link_timeout_s=30.0)
    plans = planner.plan(3 * H)[2 * H:]           # past the first rounds
    stacked = R_WK.init_stacked(jax.random.PRNGKey(0), N, DIM, HIDDEN,
                                data.n_classes)
    noise = np.random.default_rng(1)
    stacked = {k: np.asarray(v) + 0.1 * noise.normal(size=v.shape)
               .astype(np.float32) for k, v in stacked.items()}
    part_idx = np.zeros((N, max(len(p) for p in parts)), np.int32)
    for i, p in enumerate(parts):
        part_idx[i, :len(p)] = p
    return dict(plans=plans, stacked=stacked, data=data,
                part_idx=jnp.asarray(part_idx),
                part_sizes=jnp.asarray(sizes.astype(np.int32)),
                key=jax.random.PRNGKey(0x5EED))


def _ref_batches(world, ts, train_ids):
    """The minibatches the reference ``mega_round_step`` draws itself."""
    keys = jax.vmap(jax.random.fold_in, (None, 0))(world["key"],
                                                   jnp.asarray(ts))
    x, y = jnp.asarray(world["data"].x), jnp.asarray(world["data"].y)
    return jax.vmap(lambda k, ids: R_WK.sample_batches_device(
        k, ids, x, y, world["part_idx"][ids], world["part_sizes"][ids],
        STEPS, BATCH))(keys, jnp.asarray(train_ids))


@pytest.mark.parametrize("col", [True, False])
def test_packers_bit_identical(world, col):
    plans = world["plans"]
    ref = R_WK.pack_horizon(plans, col_sparse=col)
    got = T_WK.pack_horizon(plans, col_sparse=col)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    from repro_torch.core import planner as T_PL
    for lo, hi, key in T_PL.chunk_spans(plans, N, col_sparse=col):
        ref = R_WK.pack_chunk(plans[lo:hi], key, col_sparse=col)
        got = T_WK.pack_chunk(plans[lo:hi], key, col_sparse=col)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)


CASES = [  # (col_sparse, fused_sgd, mix_is_train)
    (True, True, True), (True, True, False), (False, True, True),
    (True, False, False), (False, False, False)]


@pytest.mark.parametrize("col, fused, mit", CASES)
def test_engine_matches_reference(world, col, fused, mit):
    plans = world["plans"]
    assert all(R_PL.mix_is_train(p) for p in plans)
    w_h, ctrl_h, ts = R_WK.pack_horizon(plans, col_sparse=col)
    k_mix = w_h.shape[1]
    u = w_h.shape[2] if col else 0
    mix_ids, col_ids, train_ids, masks = R_WK.split_ctrl(jnp.asarray(ctrl_h),
                                                         k_mix, u)
    xb, yb = _ref_batches(world, ts, train_ids)
    buf0, spec = R_FS.flatten_stacked(world["stacked"])
    t_buf0, t_spec = T_FS.from_reference(world["stacked"], "cpu")
    opts = dict(fused_sgd=fused, with_losses=True, mix_is_train=mit)

    # round by round: _mix_train_body from the reference's buffer, 1e-5
    t_ctrl, t_w = torch.from_numpy(ctrl_h), torch.from_numpy(w_h)
    t_xb = torch.from_numpy(np.array(xb))
    t_yb = torch.from_numpy(np.array(yb))
    r_buf = buf0
    for h in range(H):
        start = torch.from_numpy(np.array(r_buf))
        r_buf, r_loss = R_WK._mix_train_body(
            r_buf, jnp.asarray(w_h[h]), mix_ids[h],
            None if col_ids is None else col_ids[h], train_ids[h], masks[h],
            xb[h], yb[h], spec, LR, None, fused, True, mit)
        t_mids, t_cids, t_tids, t_mask = T_WK.split_ctrl(t_ctrl[h], k_mix, u)
        t_buf, t_loss = T_WK._mix_train_body(
            start, t_w[h], t_mids, t_cids, t_tids, t_mask, t_xb[h], t_yb[h],
            t_spec, LR, None, fused, True, mit)
        np.testing.assert_allclose(t_buf.numpy(), np.asarray(r_buf),
                                   atol=1e-5, rtol=0, err_msg=f"round {h}")
        np.testing.assert_allclose(t_loss.numpy(), np.asarray(r_loss),
                                   atol=1e-5, rtol=0, err_msg=f"round {h}")

    # the whole horizon: mega_round_step against the reference's scan
    r_mega, r_losses = R_WK.mega_round_step(
        jnp.array(buf0), jnp.asarray(w_h), jnp.asarray(ctrl_h),
        jnp.asarray(ts), jnp.asarray(world["data"].x),
        jnp.asarray(world["data"].y), world["part_idx"], world["part_sizes"],
        world["key"], spec=spec, lr=LR, local_steps=STEPS, batch_size=BATCH,
        col_sparse=col, **opts)
    t_mega, t_losses = T_WK.mega_round_step(
        t_buf0.clone(), t_w, t_ctrl, t_xb, t_yb, spec=t_spec, lr=LR,
        col_sparse=col, **opts)
    np.testing.assert_allclose(t_mega.numpy(), np.asarray(r_mega), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(r_losses),
                               atol=1e-4, rtol=0)
    # rows no round touched stay bit-identical
    touched = np.unique(ctrl_h[:, :k_mix])
    idle = np.setdiff1d(np.arange(N), touched)
    np.testing.assert_array_equal(t_mega.numpy()[idle],
                                  np.asarray(buf0)[idle])


def test_batch_ids_do_not_depend_on_position(world):
    """A worker's draw depends on (seed, round, worker) only."""
    parts = [np.arange(i * 50, i * 50 + 40 + i) for i in range(N)]
    a = T_WK.sample_batch_ids(0, [5, 6], np.array([[1, 2, 3], [3, 1, 2]]),
                              parts, STEPS, BATCH)
    b = T_WK.sample_batch_ids(0, [6], np.array([[2, 3, 1, 9]]), parts,
                              STEPS, BATCH)
    np.testing.assert_array_equal(a[1, 0], b[0, 1])      # worker 3, round 6
    np.testing.assert_array_equal(a[1, 1], b[0, 2])      # worker 1, round 6
    assert not np.array_equal(a[0, 0], a[1, 1])          # worker 1, 5 vs 6
    assert all(np.isin(a[0, j], parts[w]).all()         # drawn from the
               for j, w in enumerate((1, 2, 3)))         # worker's part
    c = T_WK.sample_batch_ids(1, [6], np.array([[3]]), parts, STEPS, BATCH)
    assert not np.array_equal(c[0, 0], b[0, 1])          # seed matters

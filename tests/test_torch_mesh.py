"""The port's fleet mesh (``mesh_shards > 1``) on the CPU, over gloo ranks.

Oracle ladder (mirrors tests/test_sharded_engine.py, whose multi-device
cases skip in this lane):

  * host helpers — ``shard_spans`` and ``pad_w_cols`` equal the JAX
    package's on random layouts; ``FleetSharding``'s block arithmetic;
  * the kernel twins — ``aggregate_rows_sharded``,
    ``aggregate_rows_cols_sharded`` and ``fused_sgd_sharded`` on S gloo
    ranks equal the JAX package's ``shard_map`` twins (computed in a
    subprocess over 4 forced host devices, Pallas in interpret mode) on the
    same seeded inputs, to f32 atol and rtol 1e-5, at S in {2, 4} with a
    worker count (11) that neither divides;
  * the sim engine — a planned horizon run by each rank on its block equals
    the unsharded engine's buffer to rtol 1e-5;
  * end to end — ``run_simulation`` at ``mesh_shards`` in {2, 4} keeps the
    control plane bit-identical to the unsharded run and to the JAX
    package's, and ``run_lm_federation`` on the smollm smoke config matches
    the unsharded run at the reference test's tolerances;
  * failure — a rank that raises, or dies, makes the whole call raise.

The rank functions below are module-level (the ``spawn`` start method
pickles them by name) and import nothing of jax.
"""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.planner import shard_spans
from repro_torch.dfl import flat_state as T_FS
from repro_torch.dfl import worker as T_WK
from repro_torch.kernels import aggregate as T_AGG
from repro_torch.kernels import fused_sgd as T_FSGD
from repro_torch.launch import mesh as T_MESH
from repro_torch.sharding.rules import FleetSharding

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONTROL = ("rounds", "sim_time", "comm_gb", "round_active", "staleness_avg",
           "staleness_max", "round_durations")
N_TWIN, P_TWIN, K_TWIN, U_TWIN, P_BLK = 11, 300, 4, 6, 128
SGD_DIMS = dict(dim=8, hidden=12, classes=4, steps=2, batch=4, lr=0.1)


# --------------------------------------------------------------------------- #
# host helpers
# --------------------------------------------------------------------------- #


def test_shard_spans_and_pad_w_cols_match_reference():
    pytest.importorskip("jax")
    from repro.core.planner import shard_spans as r_shard_spans
    from repro.dfl.worker import pad_w_cols as r_pad_w_cols
    rng = np.random.default_rng(0)
    for n, shards in ((10, 4), (12, 4), (11, 2), (100, 8), (7, 4)):
        for _ in range(20):
            k = int(rng.integers(0, n + 1))
            ids = np.sort(rng.choice(n, size=k, replace=True)).astype(np.int32)
            assert shard_spans(ids, n, shards) == \
                r_shard_spans(ids, n, shards), (n, shards, ids)
            w = rng.random((3, k, n)).astype(np.float32)
            n_pad = n + (-n) % shards
            np.testing.assert_array_equal(T_WK.pad_w_cols(w, n_pad),
                                          r_pad_w_cols(w, n_pad))
    with pytest.raises(ValueError, match="grouped by home shard"):
        shard_spans(np.array([5, 0]), 8, 2)


def test_fleet_sharding_blocks():
    """Blocks of the padded worker axis: 10 workers on 4 ranks pad to 12,
    rank 3 holds worker 9 and two padding rows (zero)."""
    x = np.arange(10 * 2, dtype=np.float32).reshape(10, 2) + 1
    got = []
    for rank in range(4):
        shd = FleetSharding(T_MESH.FleetMesh(4, rank, "gloo",
                                             torch.device("cpu")), 10)
        assert (shd.pad, shd.n_pad, shd.block) == (2, 12, 3)
        assert shd.home == (3 * rank, 3 * rank + 3)
        got.append(shd.put_rows_padded(x))
        assert shd.for_rows(np.array([0, 1, 4, 9, 9])) == \
            [(0, 2), (2, 3), (3, 3), (3, 5)][rank]
    assert shd.n_home_real == 1
    np.testing.assert_array_equal(torch.cat(got)[:10].numpy(), x)
    assert not torch.cat(got)[10:].any()
    assert torch.equal(shd.local(torch.tensor([9, 11])), torch.tensor([0, 2]))


def test_backend_rule_and_group_check():
    assert T_MESH.fleet_backend(2, "cpu") == "gloo"
    if torch.cuda.device_count() < 2:
        assert T_MESH.fleet_backend(2, "cuda") == "gloo"
    with pytest.raises(ValueError, match="no process group"):
        T_MESH.make_fleet_mesh(2, "cpu")


# --------------------------------------------------------------------------- #
# the kernel twins against the JAX package's shard_map twins
# --------------------------------------------------------------------------- #

_JAX_TWINS = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.dfl import flat_state as FS
from repro.dfl import worker as WK
from repro.kernels import aggregate as AGG
from repro.kernels import fused_sgd as FSGD
from repro.sharding.rules import FleetSharding

inp = dict(np.load(sys.argv[1]))
d = {k: int(inp[k]) for k in ("dim", "hidden", "classes")}
_, spec = FS.flatten_stacked(WK.init_stacked(
    jax.random.PRNGKey(0), 1, d["dim"], d["hidden"], d["classes"]))
out = {}
for s in (2, 4):
    # an Auto-axis mesh: the twins place with_sharding_constraints
    shd = FleetSharding(mesh=jax.make_mesh((s,), ("fleet",),
                                           axis_types=(AxisType.Auto,)),
                        axis="fleet")
    pad = (-inp["X"].shape[0]) % s
    x = shd.put_rows(jnp.asarray(np.pad(inp["X"], ((0, pad), (0, 0)))))
    out[f"rows{s}"] = AGG.aggregate_rows_sharded_kernel(
        jnp.asarray(np.pad(inp["W"], ((0, 0), (0, pad)))), x, shd,
        p_blk=int(inp["p_blk"]), interpret=True)
    out[f"cols{s}"] = AGG.aggregate_rows_cols_sharded_kernel(
        jnp.asarray(inp["W_sub"]), jnp.asarray(inp["col_ids"]), x, shd,
        p_blk=int(inp["p_blk"]), interpret=True)
    out[f"sgd{s}"], out[f"loss{s}"] = FSGD.fused_sgd_sharded(
        jnp.asarray(inp["rows"]), jnp.asarray(inp["xb"]),
        jnp.asarray(inp["yb"]), jnp.asarray(inp["active"]), spec,
        float(inp["lr"]), shd, with_losses=True, interpret=True)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _twin_inputs():
    rng = np.random.default_rng(7)
    d = SGD_DIMS
    spec = T_FS.spec_of(T_WK.init_stacked(torch.Generator(), 1, d["dim"],
                                          d["hidden"], d["classes"]))
    W_sub = rng.random((K_TWIN, U_TWIN)).astype(np.float32)
    W_sub[:, -1] = 0.0                    # a zero-weighted padding column
    k_sgd = 8
    return dict(
        X=rng.normal(size=(N_TWIN, P_TWIN)).astype(np.float32),
        W=rng.random((K_TWIN, N_TWIN)).astype(np.float32),
        row_ids=np.array([0, 1, 4, 5], np.int32),      # ranks 2, 3 (S=4) idle
        W_sub=W_sub,
        col_ids=np.array([1, 3, 5, 8, 10, 1], np.int32),
        crow_ids=np.array([2, 3, 9, 10], np.int32),
        train_ids=np.array([0, 2, 3, 4, 6, 7, 9, 10], np.int32),
        rows=(0.2 * rng.normal(size=(k_sgd, spec.n_params))).astype(
            np.float32),
        xb=rng.normal(size=(k_sgd, d["steps"], d["batch"], d["dim"])).astype(
            np.float32),
        yb=rng.integers(0, d["classes"],
                        (k_sgd, d["steps"], d["batch"])).astype(np.int32),
        active=np.array([1, 1, 0, 1, 1, 0, 1, 1], np.float32),
        lr=np.float32(d["lr"]), p_blk=np.int32(P_BLK),
        **{k: np.int32(d[k]) for k in ("dim", "hidden", "classes")})


@pytest.fixture(scope="module")
def jax_twins(tmp_path_factory):
    """The JAX package's three twins at S in {2, 4}, in a subprocess over 4
    forced CPU devices (the JAX package is run as it is)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("twins")
    inp = _twin_inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _JAX_TWINS,
                          str(tmp / "in.npz"), str(tmp / "out.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return inp, dict(np.load(tmp / "out.npz"))


def _twins_rank(inp):
    """Each rank's share of the three twins, gathered to every rank."""
    d = SGD_DIMS
    shd = FleetSharding.create(dist.get_world_size(), N_TWIN, "cpu")
    spec = T_FS.spec_of(T_WK.init_stacked(torch.Generator(), 1, d["dim"],
                                          d["hidden"], d["classes"]))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()}
    block = shd.put_rows_padded(t["X"])
    w_pad = torch.from_numpy(T_WK.pad_w_cols(inp["W"], shd.n_pad))
    rows = T_AGG.aggregate_rows_sharded(w_pad, block, shd,
                                        shd.for_rows(inp["row_ids"]),
                                        p_blk=P_BLK)
    cols = T_AGG.aggregate_rows_cols_sharded(
        t["W_sub"], t["col_ids"], block, shd, shd.for_rows(inp["crow_ids"]),
        p_blk=P_BLK)
    a, b = shd.for_rows(inp["train_ids"])
    new, loss = T_FSGD.fused_sgd_sharded(
        t["rows"][a:b], t["xb"][a:b], t["yb"][a:b], t["active"][a:b], spec,
        float(inp["lr"]))
    mine = [x.numpy() for x in (rows, cols, new, loss)]
    every = [None] * shd.n_shards
    dist.all_gather_object(every, mine)
    return [np.concatenate([e[i] for e in every]) for i in range(4)]


@pytest.mark.parametrize("shards", [2, 4])
def test_twins_match_jax_twins(jax_twins, shards):
    inp, ref = jax_twins
    rows, cols, new, loss = T_MESH.spawn(_twins_rank, shards, inp)
    for name, got, want in (("rows", rows, ref[f"rows{shards}"]),
                            ("cols", cols, ref[f"cols{shards}"]),
                            ("sgd", new, ref[f"sgd{shards}"]),
                            ("loss", loss, ref[f"loss{shards}"])):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    # and each twin against its plain version on the whole buffer
    np.testing.assert_allclose(rows, inp["W"] @ inp["X"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(
        cols, inp["W_sub"] @ inp["X"][inp["col_ids"]], atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------- #
# the sim engine: a planned horizon on each rank's block
# --------------------------------------------------------------------------- #

ENG_N, ENG_H, ENG_DIM, ENG_HIDDEN = 10, 8, 8, 12


def _engine_world(shards):
    from repro_torch.core.planner import HorizonPlanner
    from repro_torch.core.protocol import DySTop
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_classification
    from repro_torch.dfl.network import (EdgeNetwork, NetworkConfig,
                                         heterogeneous_compute_times)
    rng = np.random.default_rng(0)
    data = make_classification(800, ENG_DIM, seed=0)
    parts, class_counts = dirichlet_partition(data, ENG_N, 0.5, seed=0)
    sizes = np.array([len(p) for p in parts], np.float64)
    net = EdgeNetwork(NetworkConfig(n_workers=ENG_N), rng)
    h_i = heterogeneous_compute_times(ENG_N, 1.0, rng, sigma=0.75)
    planner = HorizonPlanner(
        DySTop(V=10.0, t_thre=4, max_neighbors=4), h_i=h_i,
        in_range=net.in_range(), exp_link_time=net.expected_link_time(3e4),
        model_bytes=3e4, class_counts=class_counts, data_sizes=sizes,
        net=net, rng=rng, tau_bound=5, bandwidth_budget=8.0,
        link_timeout_s=5.0, sync_link_timeout_s=30.0, mesh_shards=shards)
    plans = planner.plan(2 * ENG_H)[ENG_H:]
    stacked = T_WK.init_stacked(torch.Generator().manual_seed(0), ENG_N,
                                ENG_DIM, ENG_HIDDEN, data.n_classes)
    noise = torch.Generator().manual_seed(1)
    buf, spec = T_FS.flatten_stacked(stacked)
    buf = buf + 0.1 * torch.randn(buf.shape, generator=noise)
    return plans, buf, spec, data, parts


def _engine_run(plans, buf, spec, data, parts, col, shd):
    """What run_simulation's flush does with one chunk, on ``buf``."""
    shards = 1 if shd is None else shd.n_shards
    w, ctrl, ts = T_WK.pack_horizon(plans, col_sparse=col, shards=shards)
    k_mix = w.shape[1]
    u = w.shape[2] if col and k_mix else 0
    k_train = (ctrl.shape[1] - k_mix - u) // 2
    tids = ctrl[:, k_mix + u:k_mix + u + k_train]
    segs = None
    if shd is None:
        ids = T_WK.sample_batch_ids(0, ts, tids, parts, 2, 8)
    else:
        if not col:
            w = T_WK.pad_w_cols(w, shd.n_pad)
        segs = T_WK.shard_segments(ctrl, k_mix, u, shd)
        ids = np.concatenate([T_WK.sample_batch_ids(
            0, ts[h:h + 1], tids[h:h + 1, a:b], parts, 2, 8)[0]
            for h, (a, b) in enumerate(segs[:, 2:])])
    xb = torch.from_numpy(data.x)[torch.from_numpy(ids)]
    yb = torch.from_numpy(data.y)[torch.from_numpy(ids)]
    T_WK.mega_round_step(buf, torch.from_numpy(w), torch.from_numpy(ctrl),
                         xb, yb, spec=spec, lr=0.1, col_sparse=col,
                         fused_sgd=True, with_losses=False, mix_is_train=True,
                         shd=shd, segs=segs)
    return buf


def _engine_rank(col):
    shd = FleetSharding.create(dist.get_world_size(), ENG_N, "cpu")
    plans, buf, spec, data, parts = _engine_world(shd.n_shards)
    block = _engine_run(plans, shd.put_rows_padded(buf), spec, data, parts,
                        col, shd)
    full = shd.gather_rows(block)
    return None if full is None else full.numpy()


@pytest.mark.parametrize("shards, col", [(2, True), (4, False)])
def test_engine_buffer_matches_unsharded(shards, col):
    plans, buf, spec, data, parts = _engine_world(shards)
    want = _engine_run(plans, buf.clone(), spec, data, parts, col, None)
    got = T_MESH.spawn(_engine_rank, shards, col)
    assert got.shape == tuple(want.shape)
    # rtol 1e-5; the row-sparse twin sums its partial products in another
    # order, which near 0 leaves f32 noise of a few 1e-9 (atol 1e-6)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
    assert not np.array_equal(got, buf.numpy())       # the rounds moved it


# --------------------------------------------------------------------------- #
# end to end
# --------------------------------------------------------------------------- #

SIM_KW = dict(n_rounds=40, phi=0.5, lr=0.1, eval_every=8, seed=0, hidden=24,
              n_samples=1500)
_CACHE: dict = {}


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def _sim(n, shards, init=None):
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    return run_simulation(
        DySTop(V=10.0, t_thre=10, max_neighbors=5, max_workers=16),
        SimConfig(n_workers=n, mesh_shards=shards, **SIM_KW), device="cpu",
        init=init)


def _own_init(n):
    """The port's own initial stacked parameters as numpy arrays, handed
    over through ``init=`` (each rank keeps its block of them)."""
    stacked = T_WK.init_stacked(torch.Generator().manual_seed(SIM_KW["seed"]),
                                n, 32, SIM_KW["hidden"], 10)
    return {k: v.numpy() for k, v in stacked.items()}


def _sim_reference(n):
    from repro.core.protocol import DySTop
    from repro.dfl.simulator import SimConfig, run_simulation
    return run_simulation(
        DySTop(V=10.0, t_thre=10, max_neighbors=5, max_workers=16),
        SimConfig(n_workers=n, **SIM_KW))


@pytest.mark.parametrize("n, shards, init", [(10, 2, False), (10, 4, False),
                                             (12, 2, False), (12, 4, True)])
def test_sim_mesh_matches_unsharded_and_reference(n, shards, init):
    pytest.importorskip("jax")
    base = _cached(("sim", n), lambda: _sim(n, 1))
    ref = _cached(("ref", n), lambda: _sim_reference(n))
    got = _sim(n, shards, _own_init(n) if init else None)
    assert got.mesh_backend == "gloo" and base.mesh_backend is None
    for f in CONTROL:
        assert getattr(got, f) == getattr(base, f), f
        assert getattr(got, f) == getattr(ref, f), f
    # the reference test's tolerances for a sharded curve
    np.testing.assert_allclose(got.acc_global, base.acc_global, atol=2e-2)
    np.testing.assert_allclose(got.acc_local, base.acc_local, atol=2e-2)
    np.testing.assert_allclose(got.loss_global, base.loss_global, rtol=1e-3,
                               atol=1e-3)


def test_lm_mesh_matches_unsharded():
    """``mesh_shards=2`` on the reference test's small LM geometry (6
    workers, smoke config) at its tolerances
    (tests/test_sharded_engine.py:361-364)."""
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import lm_worker as LW
    from repro_torch.models import registry as R
    cfg = R.get_smoke_config("smollm-135m")
    kw = dict(n_workers=6, n_rounds=6, batch=1, seq=16, eval_every=3,
              seed=1)

    def mech():
        return DySTop(V=3.0, t_thre=3, max_neighbors=3, max_workers=8)

    f1, h1 = LW.run_lm_federation(mech(), cfg, LW.LMRunConfig(**kw),
                                  device="cpu")
    # the mesh run gets the same initial buffers through init=: each rank
    # keeps its block of them
    f0 = LW.init_fleet(cfg, 6, seed=kw["seed"], device="cpu")
    fs, hs = LW.run_lm_federation(mech(), cfg,
                                  LW.LMRunConfig(mesh_shards=2, **kw),
                                  device="cpu",
                                  init=(f0.pbuf.numpy(), f0.obuf.numpy()))
    assert hs.mesh_backend == "gloo"
    for f in CONTROL:
        assert getattr(hs, f) == getattr(h1, f), f
    assert fs.pbuf.shape == f1.pbuf.shape and fs.n_workers == 6
    np.testing.assert_allclose(fs.pbuf.numpy(), f1.pbuf.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(fs.obuf.numpy(), f1.obuf.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(hs.loss_global, h1.loss_global, rtol=1e-3)
    np.testing.assert_allclose(hs.round_loss, h1.round_loss, rtol=1e-3)


# --------------------------------------------------------------------------- #
# a failing rank fails the call
# --------------------------------------------------------------------------- #


def _raise_on_rank_1():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(3))       # rank 0 waits here until stopped
    return "rank 0 finished"


def _die_on_rank_1():
    if dist.get_rank() == 1:
        os._exit(3)
    dist.all_reduce(torch.ones(3))
    return "rank 0 finished"


def test_failing_rank_fails_the_call():
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="on purpose") as err:
        T_MESH.spawn(_raise_on_rank_1, 2)
    assert any("rank 1 of 2" in note for note in err.value.__notes__)
    # rank 0 sees the lost peer in its all-reduce, or the parent sees rank
    # 1 gone without a result: either way the call raises
    with pytest.raises(RuntimeError) as err:
        T_MESH.spawn(_die_on_rank_1, 2)
    assert err.value.__notes__[-1].endswith(", 3]")
    assert time.perf_counter() - t0 < 60

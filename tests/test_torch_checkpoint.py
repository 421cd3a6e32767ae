"""The port's ``checkpoint.io`` against the JAX package's, in one file layout.

Mirrors tests/test_checkpoint.py, tests/test_substrate.py's round trip and
the directory helpers of tests/test_scenarios.py on the port: bf16, int32
and f32 tensor leaves come back bit for bit with their dtypes (the LM
fleet's stacked trees and its f32 residency buffers too), numpy
control-plane leaves dtype-exact, a missing leaf raises naming it, the
write is atomic, and the directory helpers list, find and prune snapshots.
Cross-loading: a snapshot the port writes loads in
``repro.checkpoint.io.load_checkpoint`` with equal arrays, and one the JAX
package writes loads in the port's.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import io as CIO
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.dfl import flat_state as FS
from repro_torch.dfl.lm_worker import init_fleet
from repro_torch.models import registry as R
from repro_torch.tree import tree_leaves, tree_map, tree_paths


def _trees(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"a": (torch.randn((2, 3), generator=g) * 4).to(torch.bfloat16),
              "nest": {"b": torch.randn((4,), generator=g),
                       "c": [torch.arange(3, dtype=torch.int32),
                             torch.ones((2, 2))]}}
    opt = {"step": torch.tensor(7, dtype=torch.int32),
           "mu": tree_map(lambda x: x.float() * 0.5, params)}
    return params, opt


def _assert_trees_equal(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (_, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    params, opt = _trees()
    path = tmp_path / "ck.npz"
    save_checkpoint(path, params, opt, extra={"round": 7})
    tmpl_p = tree_map(torch.zeros_like, params)
    tmpl_o = tree_map(torch.zeros_like, opt)
    p2, o2, extra = load_checkpoint(path, tmpl_p, tmpl_o)
    _assert_trees_equal(params, p2)
    _assert_trees_equal(opt, o2)
    assert extra["round"] == 7
    with np.load(path) as z:
        assert "params|a::bf16" in z.files and z["params|a::bf16"].dtype \
            == np.uint16
        assert "params|nest/c/0" in z.files and "opt|mu/nest/c/1" in z.files


@pytest.fixture(scope="module")
def fleet():
    return init_fleet(R.get_smoke_config("smollm-135m"), n_workers=3, seed=0,
                      device="cpu")


def test_fleet_trees_roundtrip_bitwise(fleet, tmp_path):
    """The fleet's stacked trees (bf16 params, int32 step) survive save ->
    load, and re-flattening them gives the residency buffers bit for bit."""
    g = torch.Generator().manual_seed(3)
    pbuf = fleet.pbuf + torch.randn(fleet.pbuf.shape, generator=g) * 0.01
    sp = FS.unflatten_tree(pbuf, fleet.spec.params)      # rounds to bf16
    so = fleet.stacked_opt
    dtypes = {str(x.dtype) for x in tree_leaves(sp) + tree_leaves(so)}
    assert {"torch.bfloat16", "torch.int32"} <= dtypes
    path = tmp_path / "fleet.npz"
    save_checkpoint(path, sp, opt_state=so, extra={"round": 7})
    lp, lo, extra = load_checkpoint(path, tree_map(torch.zeros_like, sp),
                                    tree_map(torch.zeros_like, so))
    assert extra["round"] == 7
    _assert_trees_equal(sp, lp)
    _assert_trees_equal(so, lo)
    pb0, ob0, _ = FS.flatten_fleet(sp, so)
    pb1, ob1, _ = FS.flatten_fleet(lp, lo)
    assert torch.equal(pb0, pb1) and torch.equal(ob0, ob1)


def test_numpy_control_plane_leaves_restore_dtype_exact(tmp_path):
    state = {"tau": np.arange(2**40, 2**40 + 4, dtype=np.int64),
             "queue": np.array([1e-300, 1.5, np.pi], np.float64),
             "down": np.array([True, False, True])}
    path = tmp_path / "ctrl.npz"
    save_checkpoint(path, state)
    tmpl = {k: np.zeros_like(v) for k, v in state.items()}
    loaded, _, _ = load_checkpoint(path, tmpl)
    for k in state:
        assert loaded[k].dtype == state[k].dtype, k
        assert isinstance(loaded[k], np.ndarray)
        np.testing.assert_array_equal(loaded[k], state[k])


def test_missing_leaf_and_wrong_shape_are_actionable(tmp_path):
    path = tmp_path / "p.npz"
    save_checkpoint(path, {"a": np.ones(2)})
    with pytest.raises(KeyError, match=r"params\|b"):
        load_checkpoint(path, {"a": np.ones(2), "b": np.ones(2)})
    with pytest.raises(ValueError, match=r"params\|a"):
        load_checkpoint(path, {"a": torch.ones(3)})


def test_save_is_atomic_no_tmp_left_behind(tmp_path):
    path = tmp_path / "x.npz"
    save_checkpoint(path, {"a": np.ones(3)})
    save_checkpoint(path, {"a": torch.zeros(3)})      # overwrite in place
    assert [p.name for p in tmp_path.iterdir()] == ["x.npz"]
    loaded, _, _ = load_checkpoint(path, {"a": np.ones(3)})
    np.testing.assert_array_equal(loaded["a"], np.zeros(3))


def test_checkpoint_dir_helpers(tmp_path):
    assert CIO.latest_checkpoint(tmp_path) is None
    assert CIO.latest_checkpoint(tmp_path / "missing") is None
    with pytest.raises(FileNotFoundError, match="no"):
        CIO.resolve_snapshot(tmp_path)
    for t in (30, 10, 20, 40):
        CIO.save_checkpoint(CIO.checkpoint_path(tmp_path, t),
                            {"x": np.arange(3)}, extra={"round": t})
    (tmp_path / "ckpt_round000099.tmp-123.npz").write_bytes(b"partial")
    names = [p.name for p in CIO.list_checkpoints(tmp_path)]
    assert names == [f"ckpt_round{t:06d}.npz" for t in (10, 20, 30, 40)]
    assert CIO.latest_checkpoint(tmp_path).name == "ckpt_round000040.npz"
    assert CIO.resolve_snapshot(tmp_path).name == "ckpt_round000040.npz"
    first = CIO.checkpoint_path(tmp_path, 10)
    assert CIO.resolve_snapshot(first) == first
    CIO.prune_checkpoints(tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_round000030.npz", "ckpt_round000040.npz"]


def test_read_checkpoint_reads_only_the_keys_asked(tmp_path):
    path = tmp_path / "r.npz"
    save_checkpoint(path, {"pbuf": np.ones((2, 3), np.float32),
                           "obuf": np.zeros((2, 5), np.float32)},
                    extra={"config": {"arch": "x"}})
    blobs, extra = CIO.read_checkpoint(path, ("params|pbuf", "params|nope"))
    assert list(blobs) == ["params|pbuf"] and extra["config"]["arch"] == "x"
    assert set(CIO.read_checkpoint(path)[0]) == {"params|pbuf",
                                                 "params|obuf"}


def test_resume_config_check(tmp_path):
    extra = {"config": {"plane": "sim", "seed": 0}}
    CIO.check_resume_config(tmp_path / "c.npz", extra,
                            {"plane": "sim", "seed": 0, "scenario": None})
    with pytest.raises(ValueError, match="resume config mismatch.*seed"):
        CIO.check_resume_config(tmp_path / "c.npz", extra,
                                {"plane": "sim", "seed": 1})


# -- cross-loading with the JAX package ----------------------------------------


def test_port_snapshot_loads_in_reference(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint import io as R_CIO
    params, opt = _trees(1)
    ctrl = {"tau": np.arange(4, dtype=np.int64),
            "queue": np.linspace(0, 1, 4)}
    path = tmp_path / "port.npz"
    save_checkpoint(path, params, opt, extra={"round": 3, "h": [1.5, 2.5]})
    save_checkpoint(tmp_path / "ctrl.npz", {"buf": np.ones((2, 3),
                                                           np.float32)},
                    opt_state=ctrl)

    def jtmpl(tree):
        return jax.tree.map(
            lambda x: jnp.zeros(x.shape, {torch.bfloat16: jnp.bfloat16,
                                          torch.int32: jnp.int32,
                                          torch.float32: jnp.float32}[
                                              x.dtype]), tree)

    rp, ro, extra = R_CIO.load_checkpoint(path, jtmpl(params), jtmpl(opt))
    assert extra == {"round": 3, "h": [1.5, 2.5]}
    for tree, rtree in ((params, rp), (opt, ro)):
        got = jax.tree.leaves(rtree)
        want = tree_leaves(tree)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          b.float().numpy())
    rm, rc, _ = R_CIO.load_checkpoint(
        tmp_path / "ctrl.npz", {"buf": np.zeros((2, 3), np.float32)},
        {k: np.zeros_like(v) for k, v in ctrl.items()})
    for k, v in ctrl.items():
        assert rc[k].dtype == v.dtype
        np.testing.assert_array_equal(rc[k], v)


def test_reference_snapshot_loads_in_port(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint import io as R_CIO
    params = {"a": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3,
              "nest": {"b": jnp.ones((4,), jnp.float32),
                       "c": [jnp.arange(3, dtype=jnp.int32)]}}
    opt = {"step": jnp.zeros((), jnp.int32),
           "mu": jax.tree.map(lambda x: x.astype(jnp.float32), params)}
    ctrl = {"tau": np.arange(2**40, 2**40 + 3, dtype=np.int64)}
    path = tmp_path / "ref.npz"
    R_CIO.save_checkpoint(path, params, opt, extra={"round": 5})
    R_CIO.save_checkpoint(tmp_path / "ctrl.npz", ctrl)
    tdt = {"bfloat16": torch.bfloat16, "int32": torch.int32,
           "float32": torch.float32}

    def ttmpl(tree):
        return jax.tree.map(lambda x: torch.zeros(x.shape,
                                                  dtype=tdt[str(x.dtype)]),
                            tree)

    lp, lo, extra = load_checkpoint(path, ttmpl(params), ttmpl(opt))
    assert extra == {"round": 5}
    for tree, ltree in ((params, lp), (opt, lo)):
        for a, b in zip(jax.tree.leaves(tree), tree_leaves(ltree)):
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          b.float().numpy())
    lc, _, _ = load_checkpoint(tmp_path / "ctrl.npz",
                               {"tau": np.zeros(3, np.int64)})
    assert lc["tau"].dtype == np.int64
    np.testing.assert_array_equal(lc["tau"], ctrl["tau"])

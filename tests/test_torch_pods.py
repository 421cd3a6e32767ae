"""The pods-as-workers plane: ``core.protocol.dystop_pod_mix`` and
``launch.steps.make_dystop_round_step``, held against the JAX package.

The JAX package's twins run in a subprocess over 4 forced host devices,
on a ``(n_pods, 1)`` mesh of axes ``("pod", "data")`` (the package is run
as it is), on inputs made here from numpy seeds:

  * ``dystop_pod_mix`` alone on random f32 and bf16 leaves, n_pods in
    {2, 4}: within 1e-6 (f32 sums of n_pods products in another order),
    identity rows exactly;
  * two rounds of ``make_dystop_round_step(remat=True)`` on the smollm-135m
    smoke geometry in f32, a fixed W with identity rows, from the
    reference's stacked init, n_pods in {2, 4} and local_steps in {1, 2}:
    each round's metrics, and the final params and optimizer state, within
    ``tests/test_torch_train.py``'s tolerances (rtol 1e-4; atol 1e-4).  The
    optimizer is SGD with momentum: Adam's first steps move a parameter by
    about lr whatever the size of its gradient, so a gradient within f32
    noise of zero flips a whole step (one element of 295k, 1.5e-4 off, at
    local_steps 1);
  * the port's rank form (``launch.mesh.spawn``, 2 and 4 gloo ranks on the
    CPU, each holding its block of the pods) equals its stacked form bit
    for bit, with Adam: params, optimizer state and metrics.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.protocol import dystop_pod_mix
from repro_torch.dfl import flat_state as T_FS
from repro_torch.launch import mesh as T_MESH
from repro_torch.launch import steps as T_S
from repro_torch.models import registry as T_R
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_map, tree_paths
from test_torch_resume import _one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, ROUNDS, B_POD, SEQ = "smollm-135m", 2, 2, 16
REF_OPT = ("sgd", 1e-2)          # the reference parity (see docstring)
RANK_OPT = ("adam", 3e-4)        # stacked vs rank form
CASES = [(2, 1), (2, 2), (4, 1), (4, 2)]         # (n_pods, local_steps)
MIX_SHAPES = {"a": ((3, 5), "float32"), "b": ((7,), "bfloat16"),
              "c": ((2, 3, 4), "bfloat16"), "d": ((11,), "float32")}


def _mix_w(n_pods: int) -> np.ndarray:
    """A row-stochastic W with identity rows (the inactive pods: 1, 3)."""
    w = np.eye(n_pods, dtype=np.float32)
    w[0] = np.arange(n_pods, 0, -1) / np.arange(n_pods, 0, -1).sum()
    if n_pods == 4:
        w[2] = [0.0, 0.5, 0.5, 0.0]
    return w.astype(np.float32)


def _batches(n_pods: int, local_steps: int, vocab: int) -> dict:
    rng = np.random.default_rng(100 * n_pods + local_steps)
    shape = (ROUNDS, n_pods, local_steps, B_POD, SEQ)
    return {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
            "labels": rng.integers(0, vocab, shape).astype(np.int32),
            "loss_mask": np.ones(shape, np.float32)}


def _mix_leaves(n_pods: int) -> dict:
    """Random f32 draws with a leading pod axis (bf16 leaves round them)."""
    rng = np.random.default_rng(n_pods)
    return {k: rng.normal(size=(n_pods,) + shape).astype(np.float32)
            for k, (shape, _) in MIX_SHAPES.items()}


_JAX_PODS = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.core.protocol import dystop_pod_mix
from repro.launch import steps as S
from repro.models import registry as R
from repro.optim import get_optimizer
import dataclasses

inp = dict(np.load(sys.argv[1]))
meta = json.loads(sys.argv[3])
out, paths = {}, {}
cfg = dataclasses.replace(R.get_smoke_config(meta["arch"]), dtype="float32")
opt = get_optimizer(*meta["opt"])


def keyed(tree):
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             np.asarray(v)) for p, v in jax.tree_util.tree_flatten_with_path(
                 tree)[0]]


for n_pods in (2, 4):
    # Auto axes: the round step vmaps params the mix left sharded on `pod`
    # beside an optimizer state that is not
    mesh = jax.make_mesh((n_pods, 1), ("pod", "data"),
                         devices=jax.devices()[:n_pods],
                         axis_types=(AxisType.Auto, AxisType.Auto))
    leaves = {k: jnp.asarray(inp[f"mix{n_pods}_{k}"]).astype(dt)
              for k, dt in meta["mix_dtypes"].items()}
    mixed = jax.jit(lambda t, w: dystop_pod_mix(t, w, mesh))(
        leaves, jnp.asarray(inp[f"w{n_pods}"]))
    for k, v in mixed.items():
        out[f"mixed{n_pods}_{k}"] = np.asarray(v.astype(jnp.float32))
    keys = jax.random.split(jax.random.PRNGKey(0), n_pods)
    # the stacked replicas placed on the pod axis from the start, so both
    # rounds see one input sharding (one compile)
    pod = NamedSharding(mesh, P("pod"))
    init = jax.device_put(
        jax.jit(jax.vmap(lambda k: R.init_params(cfg, k)[0]))(keys), pod)
    items = keyed(init)
    paths[n_pods] = [list(p) for p, _ in items]
    for i, (_, v) in enumerate(items):
        out[f"init{n_pods}_{i}"] = v
    for local_steps in (1, 2):
        tag = f"{n_pods}_{local_steps}"
        step = jax.jit(S.make_dystop_round_step(
            cfg, opt, mesh, remat=True, local_steps=local_steps))
        params, state = init, jax.device_put(jax.vmap(opt.init)(init), pod)
        w = jnp.asarray(inp[f"w{n_pods}"])
        for r in range(meta["rounds"]):
            batch = {k: jnp.asarray(inp[f"batch{tag}_{k}"][r])
                     for k in ("tokens", "labels", "loss_mask")}
            params, state, m = step(params, state, batch, w)
            out[f"metrics{tag}_{r}"] = np.asarray(
                [float(m[k]) for k in ("ce", "moe_aux", "loss",
                                       "grad_norm")])
        for i, (_, v) in enumerate(keyed(params)):
            out[f"params{tag}_{i}"] = v
        for i, (_, v) in enumerate(keyed(state)):
            out[f"state{tag}_{i}"] = v
np.savez(sys.argv[2], **out)
print(json.dumps({str(k): v for k, v in paths.items()}))
"""


@pytest.fixture(scope="module")
def jax_pods(tmp_path_factory):
    """The JAX package's pod mix and round steps (see module docstring)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("pods")
    vocab = T_R.get_smoke_config(ARCH).vocab_size
    inp = {}
    for n_pods in (2, 4):
        inp[f"w{n_pods}"] = _mix_w(n_pods)
        for k, v in _mix_leaves(n_pods).items():
            inp[f"mix{n_pods}_{k}"] = v
    for n_pods, local_steps in CASES:
        for k, v in _batches(n_pods, local_steps, vocab).items():
            inp[f"batch{n_pods}_{local_steps}_{k}"] = v
    np.savez(tmp / "in.npz", **inp)
    meta = {"arch": ARCH, "opt": REF_OPT, "rounds": ROUNDS,
            "mix_dtypes": {k: dt for k, (_, dt) in MIX_SHAPES.items()}}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _JAX_PODS,
                          str(tmp / "in.npz"), str(tmp / "out.npz"),
                          json.dumps(meta)],
                         env=env, capture_output=True, text=True,
                         timeout=400)
    assert res.returncode == 0, res.stderr[-4000:]
    paths = {int(k): [tuple(p) for p in v]
             for k, v in json.loads(res.stdout.strip().splitlines()[-1])
             .items()}
    return inp, dict(np.load(tmp / "out.npz")), paths


def _port_leaves(inp: dict, n_pods: int, device="cpu") -> dict:
    """The mix-alone leaves as the port's tensors, in their dtypes (bf16
    rounded from the same f32 draws as the reference's)."""
    return {k: torch.from_numpy(inp[f"mix{n_pods}_{k}"]).to(
                getattr(torch, dt)).to(device)
            for k, (_, dt) in MIX_SHAPES.items()}


@pytest.mark.parametrize("n_pods", [2, 4])
def test_pod_mix_matches_reference(jax_pods, n_pods):
    inp, ref, _ = jax_pods
    w = inp[f"w{n_pods}"]
    leaves = _port_leaves(inp, n_pods)
    mixed = dystop_pod_mix(leaves, w)
    identity = [i for i in range(n_pods) if w[i, i] == 1.0]
    assert identity == ([1] if n_pods == 2 else [1, 3])
    for k, got in mixed.items():
        assert got.dtype == leaves[k].dtype and got.shape == leaves[k].shape
        want = ref[f"mixed{n_pods}_{k}"]
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6,
                                   rtol=0, err_msg=k)
        for i in identity:                   # an identity row: unchanged
            assert torch.equal(got[i], leaves[k][i]), (k, i)
        # the plain Eq. 4 in f64 on the f32 rows (before the leaf's cast)
        x = leaves[k].double().reshape(n_pods, -1).numpy()
        direct = (w.astype(np.float64) @ x).reshape(got.shape)
        f32 = leaves[k].dtype == torch.float32
        np.testing.assert_allclose(got.float().numpy(), direct, atol=1e-6,
                                   rtol=1e-6 if f32 else 2 ** -7, err_msg=k)


def test_pod_mix_checks_its_inputs():
    leaves = {"a": torch.zeros(3, 2)}
    with pytest.raises(ValueError, match="expected \\(3, 3\\)"):
        dystop_pod_mix(leaves, np.eye(2, dtype=np.float32))
    with pytest.raises(ValueError, match="pods, expected 3"):
        dystop_pod_mix({"a": torch.zeros(3, 2), "b": torch.zeros(2)},
                       np.eye(3, dtype=np.float32))


def _cfg():
    import dataclasses
    return dataclasses.replace(T_R.get_smoke_config(ARCH), dtype="float32")


def _init(ref: dict, paths: dict, n_pods: int):
    return T_FS.params_from_reference(
        [(p, ref[f"init{n_pods}_{i}"]) for i, p in enumerate(paths[n_pods])],
        "cpu")


def _run_rounds(params, n_pods, local_steps, inp, opt, mesh=None, lo=0,
                hi=None):
    """ROUNDS rounds of the port's round step with ``opt`` (name, lr) on
    pods ``[lo, hi)``; returns (params, opt state, [metrics per round as
    numpy])."""
    hi = n_pods if hi is None else hi
    opt = get_optimizer(*opt)
    state = T_S.init_pod_states(opt, params)
    step = T_S.make_dystop_round_step(_cfg(), opt, mesh, remat=True,
                                      local_steps=local_steps)
    tag = f"{n_pods}_{local_steps}"
    metrics = []
    for r in range(ROUNDS):
        batch = {k: torch.from_numpy(inp[f"batch{tag}_{k}"][r][lo:hi])
                 for k in ("tokens", "labels", "loss_mask")}
        params, state, m = step(params, state, batch, inp[f"w{n_pods}"])
        metrics.append(np.asarray([float(m[k]) for k in T_S.METRICS]))
    return params, state, metrics


@pytest.mark.parametrize("n_pods, local_steps", CASES,
                         ids=[f"pods{n}-steps{s}" for n, s in CASES])
def test_round_step_matches_reference(jax_pods, n_pods, local_steps):
    inp, ref, paths = jax_pods
    params, state, metrics = _run_rounds(_init(ref, paths, n_pods), n_pods,
                                         local_steps, inp, REF_OPT)
    tag = f"{n_pods}_{local_steps}"
    for r, got in enumerate(metrics):
        np.testing.assert_allclose(got, ref[f"metrics{tag}_{r}"], rtol=1e-4,
                                   err_msg=f"round {r} metrics")
    got_p = tree_paths(params)
    assert [p for p, _ in got_p] == paths[n_pods]
    for i, (path, got) in enumerate(got_p):
        np.testing.assert_allclose(got.numpy(), ref[f"params{tag}_{i}"],
                                   atol=1e-4, err_msg=str(path))
    got_s = tree_paths(state)
    assert len(got_s) == len(got_p) + 1                # mu, step
    for i, (path, got) in enumerate(got_s):
        want = ref[f"state{tag}_{i}"]
        if path == ("step",):
            np.testing.assert_array_equal(got.numpy(), want)
            assert int(want[0]) == ROUNDS * local_steps
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4,
                                       err_msg=str(path))


def _rank_rounds(inits: dict, inp: dict, cases: list) -> list:
    """Each case's rounds on this rank's block of the pods, the blocks
    gathered to every rank as numpy (params, state, metrics).  One
    intra-op thread, as the stacked form runs here: a CPU reduction's order
    follows the thread count."""
    torch.set_num_threads(1)
    n_sh = dist.get_world_size()
    mesh = T_MESH.make_fleet_mesh(n_sh, "cpu")
    out = []
    for n_pods, local_steps in cases:
        blk = n_pods // n_sh
        lo, hi = mesh.rank * blk, (mesh.rank + 1) * blk
        params = T_FS.params_from_reference(
            [(p, v[lo:hi]) for p, v in inits[n_pods]], "cpu")
        params, state, metrics = _run_rounds(params, n_pods, local_steps,
                                             inp, RANK_OPT, mesh, lo, hi)
        mine = [[t.numpy() for _, t in tree_paths(tree)]
                for tree in (params, state)]
        every = [None] * n_sh
        dist.all_gather_object(every, mine)
        out.append(([np.concatenate([e[0][i] for e in every])
                     for i in range(len(mine[0]))],
                    [np.concatenate([e[1][i] for e in every])
                     for i in range(len(mine[1]))], metrics))
    return out


@pytest.mark.parametrize("shards", [2, 4])
def test_rank_form_equals_stacked_form(jax_pods, shards):
    """The rank form on ``shards`` gloo ranks against the stacked form on
    the same init and batches: every case whose pods the ranks divide."""
    inp, ref, paths = jax_pods
    cases = [c for c in CASES if c[0] % shards == 0]
    inits = {n: [(p, ref[f"init{n}_{i}"]) for i, p in enumerate(paths[n])]
             for n in {c[0] for c in cases}}
    ranked = T_MESH.spawn(_rank_rounds, shards, inits, inp, cases,
                          device="cpu")
    for (n_pods, local_steps), (r_params, r_state, r_metrics) in zip(
            cases, ranked):
        params, state, metrics = _run_rounds(_init(ref, paths, n_pods),
                                             n_pods, local_steps, inp,
                                             RANK_OPT)
        for name, got, want in (("params", r_params, params),
                                ("state", r_state, state)):
            want = [t.numpy() for _, t in tree_paths(want)]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b), name
        for a, b in zip(r_metrics, metrics):
            np.testing.assert_array_equal(a, b)


def test_round_step_keeps_its_inputs_and_checks_local_steps():
    cfg = _cfg()
    params = tree_map(lambda t: torch.stack([t, t + 0.01]),
                      T_R.init_params(cfg, torch.Generator().manual_seed(0)))
    opt = get_optimizer(*RANK_OPT)
    state = T_S.init_pod_states(opt, params)
    before = [t.clone() for _, t in tree_paths(params)]
    inp = {"w2": _mix_w(2)}
    for k, v in _batches(2, 1, cfg.vocab_size).items():
        inp[f"batch2_1_{k}"] = v
    step = T_S.make_dystop_round_step(cfg, opt, local_steps=1)
    batch = {k: torch.from_numpy(inp[f"batch2_1_{k}"][0])
             for k in ("tokens", "labels", "loss_mask")}
    new, new_state, m = step(params, state, batch, inp["w2"])
    assert all(torch.equal(a, b) for a, (_, b) in zip(before,
                                                      tree_paths(params)))
    assert int(state["step"].sum()) == 0 and new_state["step"].tolist() == [1,
                                                                            1]
    assert set(m) == set(T_S.METRICS) and torch.isfinite(m["loss"])
    with pytest.raises(ValueError, match="expected 2"):
        T_S.make_dystop_round_step(cfg, opt, local_steps=2)(
            params, state, batch, inp["w2"])


def test_example_runs_on_the_cpu(monkeypatch, capsys):
    """``examples/torch_multipod_dystop.py --device cpu``: five rounds of
    WAA and the pod mix on four MLP replicas, the replica spread never
    growing (each active pod pulls a convex mix of the replicas)."""
    import runpy
    monkeypatch.setattr(sys, "argv", ["torch_multipod_dystop.py",
                                      "--device", "cpu"])
    runpy.run_path(str(ROOT / "examples" / "torch_multipod_dystop.py"),
                   run_name="__main__")
    rounds = [line for line in capsys.readouterr().out.splitlines()
              if line.startswith("round ")]
    assert [line.split(":")[0] for line in rounds] == [
        f"round {t}" for t in range(1, 6)]
    spread = [float(line.rsplit("=", 1)[1]) for line in rounds]
    assert all(np.isfinite(spread))
    assert all(b <= a for a, b in zip(spread, spread[1:])), spread

"""The dense family's train and prefill steps sharded over a (data, model)
mesh of ranks (``launch.steps.build_*_artifacts`` on ``launch.mesh.
make_rank_mesh``), on 4 gloo ranks of the CPU.

Three smoke geometries, each one case of the sharded layouts: smollm-135m
(3 heads, 1 kv head: attention replicated on the 2-way model axis, the MLP
and the vocab split), stablelm-1.6b (4 heads, MHA: head-parallel) and
gemma2-2b (GQA 4/2, softcap, a window of 64 inside the 96-token sequence,
one scanned group); each in f32 and bf16, plus stablelm and gemma2 in f32
under the ``q_seq: ("model",)`` override (context-parallel: each rank's 48
query rows against the whole sequence, the window crossing the ranks'
boundary).  From the JAX package's init (``jax.random.PRNGKey(0)``, jitted), the
loss, ``grad_norm``, every gradient leaf gathered from the ranks' blocks,
one Adam step's params and the prefill's logits are held against the
port's unsharded step and against the reference's own (``jax.jit`` of
``compute_loss``'s ``value_and_grad``, ``make_train_step`` and
``make_prefill_step`` on one CPU device):

* f32: the sharded step sums in another order than the unsharded one (the
  model-axis psums, the FSDP reduce-scatter, the vocab-parallel softmax),
  nothing else; loss and ``grad_norm`` within rtol 1e-5 of the port's and
  1e-4 of the reference's (``tests/test_torch_train.py``'s), gradients
  within atol 1e-6 (measured: <= 5e-8) and logits within 2e-5 (measured:
  <= 6.2e-6) of both.  Adam's first step moves an element by lr * g /
  (|g| + eps), about lr whatever the gradient's size, so an update that
  was skipped or went the wrong way ends about lr or 2 lr away; params
  within atol lr / 2 (measured: <= 6e-5 = 0.2 lr).
* bf16: the shared bf16 bound: loss within 2e-3 (measured: <= 1.1e-3),
  ``grad_norm`` within 2e-3 of itself, gradients and params within atol
  5e-3 and rtol 5e-2.  The logits are a bf16 product cast to f32: within
  2 bf16 ulps of the largest logit's magnitude (measured: 1).
* the update itself, which the bf16 atol cannot see (it is 17 lr): per
  rank's block of a leaf, the norm of the two updates' difference over
  the norm of the unsharded one (``_update_gap``; a skipped update reads
  1, a sign-flipped one 2) within 1e-2 in f32 (measured: <= 1.3e-3) and
  0.5 in bf16 (measured: <= 0.25, gemma2's ``ln2``: an element whose tiny
  gradient changes sign between two sum orders moves 2 lr the other
  way; an update skipped on the ranks at data 1 read 1.0).

One more case runs the reference's own sharded step (``build_train_
artifacts`` jitted with its ``in_shardings``/``out_shardings`` on a (2, 2)
mesh of 4 forced host devices, in a subprocess) and holds each rank's
blocks of the new params, and of a gradient jitted with the same specs,
to that device's shard.  A family whose step is
not sharded, and adafactor, refuse a mesh of ranks.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from _torch_sharded_ranks import (LR, assemble, counted, sharded_cases,
                                  smoke_cfg)
from repro_torch.configs.base import ShapeSpec
from repro_torch.dfl import flat_state as T_FS
from repro_torch.launch import loopcost as LC
from repro_torch.launch import mesh as T_MESH
from repro_torch.launch import steps as T_S
from repro_torch.models import registry as T_R
from repro_torch.optim import get_optimizer
from repro_torch.sharding import rules as T_SR
from repro_torch.tree import tree_paths
from test_torch_resume import _one_torch_thread  # noqa: F401

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as R_S  # noqa: E402
from repro.models import registry as R_R  # noqa: E402
from repro.optim import get_optimizer as r_get_optimizer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, SEQ = 4, 96
MESH = T_MESH.Mesh(("data", "model"), (2, 2))
QSEQ = {"q_seq": ("model",)}
# (arch, dtype, rule overrides)
CASES = [(a, d, None) for a in ("smollm-135m", "stablelm-1.6b", "gemma2-2b")
         for d in ("float32", "bfloat16")] + [
    ("stablelm-1.6b", "float32", QSEQ), ("gemma2-2b", "float32", QSEQ)]
GSPMD = 2           # stablelm-1.6b f32: also held to the reference's GSPMD
IDS = [f"{a}-{d}{'-q_seq' if o else ''}" for a, d, o in CASES]
F32 = dict(loss=1e-5, loss_ref=1e-4, grads=1e-6, logits=2e-5,
           params=0.5 * LR, update=1e-2)
BF16 = dict(loss=2e-3, atol=5e-3, rtol=5e-2, logit_ulps=2, update=0.5)


def _batch(cfg, seed=5) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(
                np.int32),
            "loss_mask": (rng.random((B, SEQ)) < 0.9).astype(np.float32)}


def _init(arch, dtype):
    """The JAX package's init (jitted) as (path, numpy leaf) items and as
    its tree, and the batch."""
    r_cfg = dataclasses.replace(R_R.get_smoke_config(arch), dtype=dtype)
    with jax.default_device(jax.devices("cpu")[0]):
        params = jax.jit(lambda key: R_R.init_params(r_cfg, key)[0])(
            jax.random.PRNGKey(0))
    items = [(tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path), np.asarray(leaf))
             for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]]
    return items, _batch(r_cfg), params


def _reference(arch, dtype, params, b):
    """One jitted program of the JAX package's loss-and-gradient, one Adam
    step (``make_train_step``) and its prefill (``make_prefill_step``)."""
    r_cfg = dataclasses.replace(R_R.get_smoke_config(arch), dtype=dtype)
    opt = r_get_optimizer("adam", LR)
    train = R_S.make_train_step(r_cfg, opt, remat=True)
    prefill = R_S.make_prefill_step(r_cfg)

    def run(params, rb):
        vg = jax.value_and_grad(
            lambda p: R_R.compute_loss(r_cfg, p, rb, remat=True)[0])(params)
        return vg, train(params, opt.init(params), rb), prefill(params, rb)

    with jax.default_device(jax.devices("cpu")[0]):
        (loss, grads), (new, _, m), logits = jax.jit(run)(
            params, {k: jnp.asarray(v) for k, v in b.items()})
    return {"loss": float(loss), "grad_norm": float(m["grad_norm"]),
            "grads": [np.asarray(g, np.float32)
                      for g in jax.tree.leaves(grads)],
            "params": [np.asarray(p, np.float32)
                       for p in jax.tree.leaves(new)],
            "logits": np.asarray(logits, np.float32)}


_JAX_SHARDED = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import ShapeSpec
from repro.launch import steps as R_S
from repro.models import registry as R_R
from repro.optim import get_optimizer
arch, lr, out = sys.argv[1], float(sys.argv[2]), sys.argv[3]
cfg = dataclasses.replace(R_R.get_smoke_config(arch), dtype="float32")
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
b = dict(np.load(out + ".batch.npz"))
shape = ShapeSpec("t", b["tokens"].shape[1], b["tokens"].shape[0], "train")
opt = get_optimizer("adam", lr)
art = R_S.build_train_artifacts(cfg, shape, mesh, opt, remat=True)
params = jax.jit(lambda key: R_R.init_params(cfg, key)[0])(
    jax.random.PRNGKey(0))
args = jax.device_put((params, opt.init(params),
                       {k: jnp.asarray(v) for k, v in b.items()}),
                      art.in_shardings)
new, _, m = jax.jit(art.step_fn, in_shardings=art.in_shardings,
                    out_shardings=art.out_shardings)(*args)
grads = jax.jit(jax.grad(
    lambda p, bb: R_R.compute_loss(cfg, p, bb, remat=True)[0]),
    in_shardings=(art.in_shardings[0], art.in_shardings[2]),
    out_shardings=art.in_shardings[0])(args[0], args[2])
ids = [d.id for d in jax.devices()[:4]]
shards = {}
for tag, tree in (("p", new), ("g", grads)):
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        for s in leaf.addressable_shards:
            shards[f"{tag}{i}_{ids.index(s.device.id)}"] = np.asarray(s.data)
np.savez(out, **shards)
print(json.dumps({k: float(v) for k, v in m.items()}))
"""


def _gspmd(arch, np_batch, out):
    """The reference's sharded step in a subprocess over 4 forced host
    devices (started, not waited for)."""
    np.savez(str(out) + ".batch.npz", **np_batch)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen([sys.executable, "-c", _JAX_SHARDED, arch,
                             str(LR), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """Every case's init, batch and reference; the reference's sharded
    step on the GSPMD case (a subprocess) and one spawn of 4 gloo ranks
    running every case (rank 0 returns every rank's blocks), both beside
    the reference's jitted runs."""
    inits = {(a, d): _init(a, d) for a, d, _ in CASES}
    out = tmp_path_factory.mktemp("gspmd") / "shards"
    proc = _gspmd(CASES[GSPMD][0], inits[CASES[GSPMD][:2]][1], out)
    ranks: dict = {}

    def run_ranks():
        try:
            ranks["every"] = T_MESH.spawn(
                sharded_cases, 4, [(a, d, o) + inits[a, d][:2]
                                   for a, d, o in CASES], device="cpu")
        except BaseException as exc:     # re-raised in the test's thread
            ranks["error"] = exc

    thread = threading.Thread(target=run_ranks)
    thread.start()
    try:
        once = {k: _reference(*k, v[2], v[1]) for k, v in inits.items()}
        thread.join()
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        thread.join()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if "error" in ranks:
        raise ranks["error"]
    assert proc.returncode == 0, stderr[-4000:]
    refs = {i: inits[a, d][:2] + (once[a, d],)
            for i, (a, d, _) in enumerate(CASES)}
    gspmd = (json.loads(stdout.strip().splitlines()[-1]),
             dict(np.load(str(out) + ".npz")))
    return refs, ranks["every"], gspmd


def _unsharded(cfg, items, np_batch):
    """The port's unsharded grad step, train step and prefill."""
    params = T_FS.params_from_reference(items, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    loss, _, grads, norm = T_S.make_grad_step(cfg)(params, batch)
    opt = get_optimizer("adam", LR)
    new, _, _ = T_S.make_train_step(cfg, opt)(params, opt.init(params),
                                              batch)
    logits = T_S.make_prefill_step(cfg)(params, batch)
    return {"loss": float(loss), "grad_norm": float(norm),
            "grads": [g.float().numpy() for g in grads],
            "params": [t.float().numpy() for _, t in tree_paths(new)],
            "logits": logits.float().numpy()}


def _close(got, want, dtype, what, f32_atol):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=f32_atol,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16["rtol"],
                                   atol=BF16["atol"], err_msg=what)


def _update_gap(new, want, init) -> float:
    """How far the sharded step's update of a rank's block is from
    ``want``'s: the norm of (new - init) - (want - init) over that of
    want - init (a skipped update reads 1, a sign-flipped one 2)."""
    return float(np.linalg.norm((new - want).astype(np.float64))
                 / max(np.linalg.norm((want - init).astype(np.float64)),
                       1e-30))


def _logits_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32["logits"])
        return
    live = want > -1e29                       # the padded columns: -1e30
    top = np.abs(want[live]).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.array_equal(got > -1e29, live)
    assert np.abs(got[live] - want[live]).max() <= BF16["logit_ulps"] * ulp


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_sharded_step_matches_unsharded_and_reference(ranked, case):
    arch, dtype, over = CASES[case]
    refs, every, _ = ranked
    items, np_batch, ref = refs[case]
    cfg = smoke_cfg(arch, dtype)
    port = _unsharded(cfg, items, np_batch)
    art = T_S.build_train_artifacts(cfg, ShapeSpec("t", SEQ, B, "train"),
                                    MESH, get_optimizer("adam", LR),
                                    rule_overrides=over)
    ranks = [every[r][case] for r in range(4)]
    loss, norm, metrics = ranks[0][:3]
    for r in range(1, 4):                       # metrics are replicated
        assert ranks[r][:3] == (loss, norm, metrics), r
    assert metrics["loss"] == loss and metrics["grad_norm"] == norm
    for want, bound in ((port, F32["loss"]), (ref, F32["loss_ref"])):
        for got, k in ((loss, "loss"), (norm, "grad_norm")):
            if dtype == "float32":
                np.testing.assert_allclose(got, want[k], rtol=bound,
                                           err_msg=k)
            else:
                assert abs(got - want[k]) <= BF16["loss"] * (
                    1 if k == "loss" else want[k]), (k, got, want[k])
    leaves = tree_paths(art.abstract_args[0])
    specs = [sp for _, sp in tree_paths(art.in_shardings[0])]
    moved = []
    for i, ((path, g), sp) in enumerate(zip(leaves, specs)):
        name = ".".join(map(str, path))
        grad = assemble([rk[3][i] for rk in ranks], sp, g.shape)
        new = assemble([rk[4][i] for rk in ranks], sp, g.shape)
        init = np.asarray(items[i][1], np.float32)
        for want in (port, ref):
            _close(grad, want["grads"][i], dtype, f"d{name}", F32["grads"])
            _close(new, want["params"][i], dtype, name, F32["params"])
            moved += [(_update_gap(rk[4][i], *(T_SR.local_slice(
                torch.from_numpy(t), sp, T_MESH.rank_view(MESH, r)).numpy()
                for t in (want["params"][i], init))), name, r)
                for r, rk in enumerate(ranks)]
    bound = (F32 if dtype == "float32" else BF16)["update"]
    assert max(moved)[0] <= bound, (max(moved), bound)
    lspec = T_S.build_prefill_artifacts(
        cfg, ShapeSpec("p", SEQ, B, "prefill"), MESH,
        rule_overrides=over).out_shardings
    logits = assemble([rk[5] for rk in ranks], lspec, port["logits"].shape)
    for want in (port, ref):
        _logits_close(logits, want["logits"], dtype)


def test_rank_blocks_match_the_reference_sharded_jit(ranked):
    """The reference's own ``build_train_artifacts`` step, jitted with its
    specs on a (2, 2) mesh of 4 forced host devices (GSPMD), and its
    gradient jitted with the params' and batch's specs, against the
    port's 4 gloo ranks from the same init and batch (stablelm-1.6b smoke,
    f32, head-parallel): each rank's gradient blocks within the f32
    gradient bound of that device's shard, its blocks of the new params
    within the f32 params bound (see the module docstring), and the
    metrics within rtol 1e-4."""
    _, every, (want_m, want) = ranked
    for r in range(4):
        _, _, metrics, grads, blocks = every[r][GSPMD][:5]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(metrics[k], want_m[k], rtol=1e-4)
        for tag, got, atol in (("g", grads, F32["grads"]),
                               ("p", blocks, F32["params"])):
            for i, blk in enumerate(got):
                shard = want[f"{tag}{i}_{r}"]
                assert blk.shape == shard.shape, (tag, i, r)
                np.testing.assert_allclose(blk, shard, rtol=0, atol=atol,
                                           err_msg=f"{tag} leaf {i} rank {r}")


def test_meta_rank_view_counts_what_a_gloo_rank_counts(ranked):
    """The dry-run's count of one device (``launch.loopcost.step_costs`` of
    the sharded train step on ``rank_view``'s ``meta`` blocks) equals what
    rank 0 of the gloo run counted for the same step: the collective calls
    and bytes by kind, the flops and the kernel calls (smollm-135m smoke,
    f32)."""
    _, every, _ = ranked
    cfg = smoke_cfg("smollm-135m", "float32")
    art = T_S.build_train_artifacts(cfg, ShapeSpec("t", SEQ, B, "train"),
                                    T_MESH.rank_view(MESH),
                                    get_optimizer("adam", LR))
    meta = counted(LC.step_costs(art.step_fn, *art.local_args))
    assert meta == every[0][0][6]
    calls, _, flops, kernels = meta
    assert set(calls) == {"all-gather", "all-reduce", "reduce-scatter"}
    # remat: each layer's flash once in the forward, once in the recompute
    assert flops > 0 and kernels == {"flash_attention": 2 * cfg.n_layers}


def test_unported_families_and_adafactor_refuse_a_rank_mesh():
    """The moe family (item 9(b) of the roadmap) on a mesh of ranks raises
    rather than running replicated: its train and prefill artifacts, and
    the steps built directly; adafactor's update on the dense family's
    sharded step raises too (on ``meta``, rank 0 of the 2 x 2 mesh)."""
    view = T_MESH.rank_view(MESH)
    shape = ShapeSpec("t", 32, 4, "train")
    moe = T_R.get_smoke_config("grok-1-314b")
    with pytest.raises(NotImplementedError, match=r"9\(b\)"):
        T_S.build_train_artifacts(moe, shape, view, get_optimizer("adam"))
    with pytest.raises(NotImplementedError, match=r"9\(b\)"):
        T_S.build_prefill_artifacts(moe, shape, view)
    with pytest.raises(NotImplementedError, match=r"9\(b\)"):
        T_S.make_grad_step(moe, mesh=view)
    with pytest.raises(NotImplementedError, match=r"9\(b\)"):
        T_S.make_prefill_step(moe, mesh=view)
    art = T_S.build_train_artifacts(T_R.get_smoke_config("smollm-135m"),
                                    shape, view, get_optimizer("adafactor"))
    with pytest.raises(NotImplementedError, match=r"adafactor.*9\(b\)"):
        art.step_fn(*art.local_args)

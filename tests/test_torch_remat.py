"""Activation recomputation (``remat=True``) in the port's model plane.

``remat`` changes memory, not values: non-reentrant checkpointing records
the same autograd graph and recomputes each checkpointed region's forward
with the same ops on the same inputs when the backward pass needs it.  So,
for one smoke geometry of each family the port trains (dense, moe, ssm,
hybrid, vlm, enc-dec), ``compute_loss(remat=True)``'s loss and every
gradient equal ``remat=False``'s bit for bit (the hybrid's excepted: there
the reference's own remat and plain runs differ, and the port's remat is
held to the reference's remat), and the checkpointed layers run twice
(the layer groups of ``blocks``; every encoder and decoder layer).
``make_train_step(remat=True)`` is held against the JAX package's
``jax.jit(make_train_step(..., remat=True))`` from the reference's init on
the same batches, in f32, within ``tests/test_torch_train.py``'s
tolerances (losses and ``grad_norm`` rtol 1e-4, params atol 1e-4).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.dfl import flat_state as T_FS
from repro_torch.launch import steps as T_S
from repro_torch.models import encdec as T_E
from repro_torch.models import registry as T_R
from repro_torch.models import transformer as T_T
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_from_paths, tree_paths
from test_torch_resume import _one_torch_thread  # noqa: F401

# (arch, family, seq): mamba2's seq is its smoke chunk (32)
FAMILIES = [("smollm-135m", "dense", 32), ("grok-1-314b", "moe", 32),
            ("mamba2-2.7b", "ssm", 32), ("recurrentgemma-2b", "hybrid", 32),
            ("paligemma-3b", "vlm", 24), ("seamless-m4t-medium", "encdec", 32)]
IDS = [f[1] for f in FAMILIES]
B = 2


def _np_batch(cfg, seq: int, seed: int = 5) -> dict:
    """Tokens, labels, a loss mask and the family's stub feed, in numpy
    (the stub feed in f32)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq)).astype(
               np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, seq)).astype(
               np.int32),
           "loss_mask": np.ones((B, seq), np.float32)}
    if T_R.has_prefix(cfg):
        out["prefix_embeds"] = rng.normal(
            size=(B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if T_R.is_encdec(cfg):
        out["frames"] = rng.normal(
            size=(B, T_R.frames_for(cfg, seq), cfg.d_model)).astype(
                np.float32)
    return out


def _torch_batch(cfg, b: dict) -> dict:
    dt = getattr(torch, cfg.dtype)
    return {k: (torch.from_numpy(v).to(dt)
                if k in ("prefix_embeds", "frames") else torch.from_numpy(v))
            for k, v in b.items()}


def _loss_and_grads(cfg, params, batch, remat):
    leaves = [t.detach().requires_grad_() for _, t in tree_paths(params)]
    p = tree_from_paths(zip([q for q, _ in tree_paths(params)], leaves))
    loss, parts = T_R.compute_loss(cfg, p, batch, remat=remat)
    return loss, parts, torch.autograd.grad(loss, leaves)


def _counting(monkeypatch, module, name):
    """Count the calls of ``module.name`` (a layer function)."""
    calls = [0]
    orig = getattr(module, name)

    def counted(*args, **kw):
        calls[0] += 1
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("arch, family, seq", FAMILIES, ids=IDS)
def test_remat_loss_and_grads_are_bit_equal(monkeypatch, arch, family, seq):
    cfg = T_R.get_smoke_config(arch)
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _torch_batch(cfg, _np_batch(cfg, seq))
    if T_R.is_encdec(cfg):
        enc = _counting(monkeypatch, T_E, "_encoder_layer")
        dec = _counting(monkeypatch, T_E, "_decoder_layer")
        counters, once = (enc, dec), (cfg.n_enc_layers, cfg.n_layers)
        twice = (2 * cfg.n_enc_layers, 2 * cfg.n_layers)
    else:
        lay = _counting(monkeypatch, T_T, "apply_layer")
        n_pre, n_grp, _ = T_T.structure(cfg)
        counters, once = (lay,), (cfg.n_layers,)
        twice = (cfg.n_layers + n_grp * len(T_T.pattern(cfg)),)
        assert n_grp > 0
    plain = _loss_and_grads(cfg, params, batch, remat=False)
    assert tuple(c[0] for c in counters) == once
    for c in counters:
        c[0] = 0
    rem = _loss_and_grads(cfg, params, batch, remat=True)
    assert tuple(c[0] for c in counters) == twice   # the recompute ran
    assert torch.isfinite(plain[0])
    if family == "hybrid":
        _hybrid_remat_against_reference(arch, seq)
        return
    assert torch.equal(rem[0], plain[0])
    for k in ("ce", "moe_aux"):
        assert torch.equal(rem[1][k], plain[1][k]), k
    for (path, _), got, want in zip(tree_paths(params), rem[2], plain[2]):
        assert got.dtype == want.dtype and torch.equal(got, want), path


def _hybrid_remat_against_reference(arch, seq):
    """The hybrid family's remat: held to the reference's own remat, at
    the bound its plain pair meets.  Under ``jax.checkpoint`` the
    reference's forward keeps the RG-LRU conv's last product f32 and its
    backward's recompute rounds it, so its own remat and plain losses
    differ; the port does the same (``rglru._conv``).  Each gradient leaf
    of the port's remat run is within ``_torch_blocks.bound`` of the share
    beyond one bf16 ulp that its plain run reads against the reference's
    plain run (1.5 times, at least 0.02 % more), and the loss gap within
    1.5 times the plain gap plus 1e-4."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from _torch_blocks import _flat, bound, shares
    from repro.kernels.config import KernelConfig
    from repro.models import registry as R_R
    r_cfg = dataclasses.replace(R_R.get_smoke_config(arch),
                                kernels=KernelConfig(backend="pallas"))
    t_cfg = T_R.get_smoke_config(arch)
    b = _np_batch(t_cfg, seq)
    ref = {}
    with jax.default_device(jax.devices("cpu")[0]):
        r_params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(0))
        rb = {k: jnp.asarray(v).astype(r_cfg.dtype) if v.dtype == np.float32
              and k != "loss_mask" else jnp.asarray(v) for k, v in b.items()}
        for remat in (False, True):
            loss, g = jax.jit(jax.value_and_grad(
                lambda p, r=remat: R_R.compute_loss(r_cfg, p, rb,
                                                    remat=r)[0]))(r_params)
            ref[remat] = (float(loss), dict(_flat(g)))
    t_params = T_FS.params_from_reference(
        [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
          np.asarray(leaf)) for path, leaf in
         jax.tree_util.tree_flatten_with_path(r_params)[0]], "cpu")
    batch = _torch_batch(t_cfg, b)
    paths = [".".join(map(str, q)) for q, _ in tree_paths(t_params)]
    far, gap = {}, {}
    for remat in (False, True):
        loss, _, grads = _loss_and_grads(t_cfg, t_params, batch, remat)
        gap[remat] = abs(float(loss.detach()) - ref[remat][0])
        far[remat] = {q: shares(g.float().numpy(),
                                np.asarray(ref[remat][1][q], np.float32))[1]
                      for q, g in zip(paths, grads)}
    assert ref[True][0] != ref[False][0]
    print(f"loss gaps: plain {gap[False]:.3e}, remat {gap[True]:.3e}")
    assert gap[True] <= 1.5 * gap[False] + 1e-4, gap
    for q in paths:
        print(f"{q}: far plain {far[False][q]:.4%} remat {far[True][q]:.4%}")
        assert far[True][q] <= bound(far[False][q]), q


def test_remat_train_step_is_the_default_and_bit_equal():
    """``make_train_step``'s default is ``remat=True``; two steps with it
    give the params, optimizer state and metrics of ``remat=False`` to the
    bit (bf16 smoke geometry, Adam)."""
    cfg = T_R.get_smoke_config("smollm-135m")
    opt = get_optimizer("adam", 1e-3)
    batch = _torch_batch(cfg, _np_batch(cfg, 32))
    out = {}
    for name, step in (("default", T_S.make_train_step(cfg, opt)),
                       ("plain", T_S.make_train_step(cfg, opt,
                                                     remat=False))):
        p = T_R.init_params(cfg, torch.Generator().manual_seed(0))
        s = opt.init(p)
        for _ in range(2):
            p, s, m = step(p, s, batch)
        out[name] = (p, s, m)
    (p1, s1, m1), (p0, s0, m0) = out["default"], out["plain"]
    for tree1, tree0 in ((p1, p0), (s1, s0)):
        for (path, a), (_, b) in zip(tree_paths(tree1), tree_paths(tree0)):
            assert torch.equal(a, b), path
    assert all(torch.equal(m1[k], m0[k]) for k in m0)


@pytest.mark.parametrize("arch, family, seq", FAMILIES, ids=IDS)
def test_remat_train_step_matches_reference(arch, family, seq):
    """Two ``make_train_step(remat=True)`` steps (Adam, lr 3e-4, as in
    ``tests/test_torch_train.py``) against the JAX
    package's jitted remat step from its own init, f32, same batches."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.launch import steps as R_S
    from repro.models import registry as R_R
    from repro.optim import get_optimizer as r_get_optimizer
    r_cfg = dataclasses.replace(R_R.get_smoke_config(arch), dtype="float32")
    t_cfg = dataclasses.replace(T_R.get_smoke_config(arch), dtype="float32")
    batches = [_np_batch(t_cfg, seq, seed) for seed in (5, 6)]
    with jax.default_device(jax.devices("cpu")[0]):
        r_params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(0))
        r_opt = r_get_optimizer("adam", 3e-4)
        r_state = r_opt.init(r_params)
        r_step = jax.jit(R_S.make_train_step(r_cfg, r_opt, remat=True))
        r_metrics = []
        t_params = T_FS.params_from_reference(
            [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
              np.asarray(leaf)) for path, leaf in
             jax.tree_util.tree_flatten_with_path(r_params)[0]], "cpu")
        for b in batches:
            r_params, r_state, m = r_step(
                r_params, r_state, {k: jnp.asarray(v) for k, v in b.items()})
            r_metrics.append({k: float(v) for k, v in m.items()})
        r_leaves = [np.asarray(x) for x in jax.tree.leaves(r_params)]
    t_opt = get_optimizer("adam", 3e-4)
    t_state = t_opt.init(t_params)
    t_step = T_S.make_train_step(t_cfg, t_opt, remat=True)
    for b, want in zip(batches, r_metrics):
        t_params, t_state, got = t_step(t_params, t_state,
                                        _torch_batch(t_cfg, b))
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4,
                                       err_msg=k)
    leaves = tree_paths(t_params)
    assert len(leaves) == len(r_leaves)
    for (path, got), want in zip(leaves, r_leaves):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4,
                                   err_msg=str(path))

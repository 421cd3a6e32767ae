"""The port's ssm family (mamba2) and its ``ssd_chunk`` kernel, held against
the JAX package.

On the CPU the kernel's wrapper runs its plain version; that is held against
the Pallas ``ssd_chunk`` in interpret mode and the JAX package's oracle, and
the autograd backward against ``jax.vjp`` of the oracle, jax pinned to its
CPU backend.  The mamba2 smoke model goes through both packages from the
reference's init, with the reference's intra-chunk term in its Pallas
kernel (``KernelConfig(backend="pallas")``): f32 loss to 1e-5 and gradients
to 1e-4; bf16 loss to 2e-3 and gradients atol 5e-3, rtol 5e-2, as
``tests/test_torch_models.py`` holds the dense family.  The federation runs
the smoke config for 9 rounds from the reference's initial buffers: control
plane bit for bit, ``loss_global`` to 1e-4 in f32 and 1e-2 in bf16 (as
``tests/test_torch_lm.py``).  The reference's federation runs its einsum
intra-chunk form (the Pallas kernel in interpret mode would double the
file's time; the model test above holds the port against the kernel) at
seq 32, one chunk.  The CUDA kernel runs only on a card
(``test_cuda_ssd_chunk_matches_plain_version``, marker ``cuda``).

What the scalar bf16 bound can and cannot catch.  The loss gap against the
reference moves with the token seed: over seeds 5-10 it spans 1.1e-5 to 6.1e-4; the
reference's own bf16 loss differs from its f32 one by 7e-5 to 8.8e-3.  The
bound measures the spread of sum-order noise (bf16 products accumulated in
another order, each flip carried downstream), so it catches a wrong
function, not a rounding place moved: an ignored ``attn_impl="chunked"``
read 1.97e-3 on the vlm family, and a rounding of the RG-LRU conv's
output that the compiled reference's forward skips, which moved 38-43 %
of its layer's outputs, left the hybrid loss inside the same spread.  Rounding places are held block by block, on the
reference's own residual stream, by ``tests/test_torch_blocks*.py`` (the
harness is ``tests/_torch_blocks.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.protocol import DySTop
from repro_torch.dfl import flat_state as T_FS
from repro_torch.dfl import lm_worker as T_LW
from repro_torch.kernels import ops as T_OPS
from repro_torch.kernels import ssd_chunk as T_SC
from repro_torch.models import registry as T_R
from repro_torch.models import ssm as T_S
from repro_torch.tree import tree_from_paths, tree_paths
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCH = "mamba2-2.7b"
B, S = 2, 64                 # two 32-step chunks of the smoke config
CONTROL = ("rounds", "sim_time", "comm_gb", "staleness_avg", "staleness_max",
           "round_durations", "round_active")
KW = dict(n_workers=4, n_rounds=9, batch=2, seq=32, eval_every=3, seed=1)


def _ssd_inputs(seed, g, h, q, n, p, rate=0.1):
    """Inputs as the reference's own test draws them: la a cumulative sum of
    negative log decays, ``rate`` per step on average."""
    rng = np.random.default_rng(seed)
    Bc = rng.normal(size=(g, q, n)).astype(np.float32)
    Cc = rng.normal(size=(g, q, n)).astype(np.float32)
    step = np.log1p(np.exp(rng.normal(size=(g, h, q))))
    la = (-np.cumsum(step * rate, axis=-1)).astype(np.float32)
    xb = rng.normal(size=(g, h, q, p)).astype(np.float32)
    return Bc, Cc, la, xb


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# --------------------------------------------------------------------------- #
# the kernel's plain version and its gradient
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("g, h, q, n, p", [(2, 2, 32, 16, 16),
                                           (4, 8, 64, 32, 64),
                                           (1, 4, 128, 128, 32)])
def test_ssd_chunk_plain_matches_pallas(g, h, q, n, p):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as R_REF
    from repro.kernels import ssd_chunk as R_SC
    ins = _ssd_inputs(g * 100 + q, g, h, q, n, p)
    got = T_SC.ssd_chunk(*_t(*ins))
    assert got.dtype == torch.float32 and got.shape == (g, h, q, p)
    with jax.default_device(jax.devices("cpu")[0]):   # full f32 products
        js = [jnp.asarray(a) for a in ins]
        pallas = R_SC.ssd_chunk(*js, interpret=True)
        oracle = R_REF.ssd_chunk_ref(*js)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   rtol=2e-4)


def test_ssd_chunk_is_causal():
    """Future positions inside the chunk do not reach earlier outputs."""
    Bc, Cc, la, xb = _ssd_inputs(9, 1, 2, 32, 16, 16)
    base = T_SC.ssd_chunk(*_t(Bc, Cc, la, xb))
    for arr in (Bc, Cc, xb):
        arr[..., 20:, :] += 5.0
    la[..., 20:] -= 3.0
    moved = T_SC.ssd_chunk(*_t(Bc, Cc, la, xb))
    assert torch.equal(moved[:, :, :20], base[:, :, :20])
    assert not torch.equal(moved[:, :, 20:], base[:, :, 20:])


def test_ssd_chunk_diff_gradient_matches_jax_vjp():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as R_REF
    ins = _ssd_inputs(11, 2, 3, 48, 16, 32)
    g = np.random.default_rng(12).normal(size=(2, 3, 48, 32)).astype(
        np.float32)
    t = [a.requires_grad_() for a in _t(*ins)]
    out = T_OPS.ssd_chunk_diff(*t)
    grads = torch.autograd.grad(out, t, torch.from_numpy(g))
    with jax.default_device(jax.devices("cpu")[0]):
        j_out, pullback = jax.vjp(R_REF.ssd_chunk_ref,
                                  *(jnp.asarray(a) for a in ins))
        j_grads = pullback(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=2e-4, rtol=2e-4)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def test_ssd_chunk_large_dt_gradient_is_finite():
    """Head 0 decays fast: its masked exponents la_q - la_t (t > q) pass
    f32's exp limit.  The reference's ``where(causal, exp(decay), 0)`` then
    gives 0 * inf = NaN in its cum_la gradient; the port masks before
    ``exp``, so its gradient is finite, and equal to the reference's
    wherever that is finite.  Head 1 decays slowly and stays finite in
    both."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as R_REF
    Bc, Cc, la, xb = _ssd_inputs(13, 2, 2, 64, 16, 16)
    la[:, 0] *= 40.0                  # ~ -180 at the chunk's end
    assert float((la[:, 0, 0] - la[:, 0, -1]).min()) > 100.0
    g = np.random.default_rng(14).normal(size=xb.shape).astype(np.float32)
    t = [a.requires_grad_() for a in _t(Bc, Cc, la, xb)]
    out = T_OPS.ssd_chunk_diff(*t)
    grads = torch.autograd.grad(out, t, torch.from_numpy(g))
    with jax.default_device(jax.devices("cpu")[0]):
        j_out, pullback = jax.vjp(R_REF.ssd_chunk_ref,
                                  *(jnp.asarray(a) for a in (Bc, Cc, la, xb)))
        j_grads = [np.asarray(a) for a in pullback(jnp.asarray(g))]
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=2e-4, rtol=2e-4)
    assert not np.isfinite(j_grads[2][:, 0]).all()    # the case is real
    assert np.isfinite(j_grads[2][:, 1]).all()
    for got, want in zip(grads, j_grads):
        assert torch.isfinite(got).all()
        ok = np.isfinite(want)
        np.testing.assert_allclose(got.numpy()[ok], want[ok], atol=1e-4,
                                   rtol=1e-4)


def test_ssd_chunk_checks_its_inputs():
    Bc, Cc, la, xb = _t(*_ssd_inputs(1, 2, 3, 16, 8, 16))
    with pytest.raises(ValueError, match="Bc and Cc"):
        T_SC.ssd_chunk(Bc, Cc[:, :8], la, xb)
    with pytest.raises(ValueError, match="xbar"):
        T_SC.ssd_chunk(Bc, Cc, la, xb[:, :, :8])
    with pytest.raises(ValueError, match="cum_la"):
        T_SC.ssd_chunk(Bc, Cc, la[:, :2], xb)
    with pytest.raises(ValueError, match="head_dim"):
        T_SC.check_sizes(8, 80, 256, 128, 48)
    with pytest.raises(ValueError, match="chunk Q"):
        T_SC.check_sizes(8, 80, 1024, 128, 64)
    with pytest.raises(ValueError, match="grid"):
        T_SC.check_sizes(70_000, 80, 256, 128, 64)
    T_SC.check_sizes(8, 80, 256, 128, 64)


@pytest.mark.parametrize("g, h, q, ok", [
    (8, 80, 256, True),                 # the mamba2 path
    (1, 524_288 * 8, 64, True),         # H past the old 65,535 head groups
    (65_535, 4096, 512, True),          # 2^31 - 2^19 blocks of the 1-D grid
    (65_535, 4097, 512, False)])        # past 2^31 - 1
def test_ssd_chunk_grid_limits(g, h, q, ok):
    """One block per (query tile of 64 rows, head, g) on a 1-D grid: H is no
    longer bounded by a grid axis, only the block count by 2^31 - 1."""
    if ok:
        T_SC.check_sizes(g, h, q, 128, 64)
    else:
        with pytest.raises(ValueError, match="blocks"):
            T_SC.check_sizes(g, h, q, 128, 64)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


def _paths(tree):
    import jax
    return [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _to_torch(params):
    import jax
    return tree_from_paths(
        (p, torch.from_numpy(np.array(leaf.astype("float32")))
         .to(getattr(torch, str(leaf.dtype))))
        for p, leaf in zip(_paths(params), jax.tree.leaves(params)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_loss_and_grads_match_reference(dtype):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.config import KernelConfig
    from repro.models import registry as R_R
    r_cfg = dataclasses.replace(R_R.get_smoke_config(ARCH), dtype=dtype,
                                kernels=KernelConfig(backend="pallas"))
    rng = np.random.default_rng(5)
    tok = rng.integers(0, r_cfg.vocab_size, size=(B, S)).astype(np.int32)
    lab = rng.integers(0, r_cfg.vocab_size, size=(B, S)).astype(np.int32)
    with jax.default_device(jax.devices("cpu")[0]):
        r_params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
                 "loss_mask": jnp.ones((B, S), jnp.float32)}
        r_loss, r_grads = jax.value_and_grad(
            lambda p: R_R.compute_loss(r_cfg, p, batch)[0])(r_params)
    params = _to_torch(r_params)
    flat = [leaf.requires_grad_() for _, leaf in tree_paths(params)]
    cfg = dataclasses.replace(T_R.get_smoke_config(ARCH), dtype=dtype)
    loss, _ = T_R.compute_loss(cfg, params, {
        "tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
        "loss_mask": torch.ones((B, S))})
    grads = torch.autograd.grad(loss, flat)
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               atol=1e-5 if f32 else 2e-3)
    for got, want in zip(grads, jax.tree.leaves(r_grads)):
        want = np.asarray(want.astype(jnp.float32))
        if f32:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
        else:
            np.testing.assert_allclose(got.float().numpy(), want, atol=5e-3,
                                       rtol=5e-2)


def test_init_and_configs_match_reference():
    """The port's own init has the reference's leaves, shapes and dtypes in
    the reference's order (A_log, D, dt_bias and norm f32, the rest bf16),
    the same fixed values where the init is not random (to one f32 ulp:
    XLA's and PyTorch's ``linspace`` and ``log`` differ in the last bit),
    and both configs carry the reference's fields."""
    jax = pytest.importorskip("jax")
    from repro.models import registry as R_R
    for get in ("get_config", "get_smoke_config"):
        r = dataclasses.asdict(getattr(R_R, get)(ARCH))
        t = dataclasses.asdict(getattr(T_R, get)(ARCH))
        r.pop("kernels"), t.pop("kernels")
        assert r == t, get
    with jax.default_device(jax.devices("cpu")[0]):
        r_params, _ = R_R.init_params(R_R.get_smoke_config(ARCH),
                                      jax.random.PRNGKey(0))
    t_params = T_R.init_params(T_R.get_smoke_config(ARCH),
                               torch.Generator().manual_seed(0))
    got = [(p, tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
           for p, leaf in tree_paths(t_params)]
    want = [(p, tuple(leaf.shape), str(leaf.dtype))
            for p, leaf in zip(_paths(r_params), jax.tree.leaves(r_params))]
    assert got == want
    r_ssm, t_ssm = r_params["blocks"]["p0"]["ssm"], t_params["blocks"]["p0"][
        "ssm"]
    for k in ("A_log", "D", "dt_bias", "norm", "conv_b"):
        np.testing.assert_allclose(
            t_ssm[k].float().numpy(), np.asarray(r_ssm[k].astype("float32")),
            rtol=2.4e-7, atol=0)
    assert "mlp" not in t_params["blocks"]["p0"]       # d_ff == 0


def test_ssm_decoding_and_ragged_seq_raise():
    """Decoding is ported (serving): the cache and one step run, the state
    stays f32 and the step writes it in place; a ragged seq still raises
    (held against the reference in tests/test_torch_decode.py)."""
    cfg = T_R.get_smoke_config(ARCH)
    cache = T_S.init_ssm_cache(cfg, 1, torch.bfloat16)
    assert cache["state"].dtype == torch.float32
    assert cache["conv_tail"].dtype == torch.bfloat16
    p = T_S.init_ssm(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((1, 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    out, new = T_S.ssm_decode_step(cfg, p, cache, x.to(torch.bfloat16))
    assert out.shape == (1, 1, cfg.d_model) and out.dtype == torch.bfloat16
    assert new is cache and bool(cache["state"].abs().sum() > 0)
    assert bool(cache["conv_tail"][:, -1].abs().sum() > 0)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        T_S.ssm_forward(cfg, p, torch.zeros((1, 48, cfg.d_model)))


# --------------------------------------------------------------------------- #
# the fleet and the federation
# --------------------------------------------------------------------------- #


def _mech():
    return DySTop(V=3.0, t_thre=10, max_neighbors=3)


def test_fleet_layout_matches_reference():
    """The mamba2 fleet's columns, shapes and mixed dtypes match the
    reference's FleetSpec, and ``fleet_from_reference`` carries its
    buffers across bit for bit, bf16 and f32 leaves alike."""
    jax = pytest.importorskip("jax")
    from repro.dfl import lm_worker as R_LW
    from repro.models import registry as R_R
    with jax.default_device(jax.devices("cpu")[0]):
        ref = R_LW.init_fleet(R_R.get_smoke_config(ARCH), 3, seed=2)
        r_params = ref.stacked_params
    fleet = T_LW.init_fleet(T_R.get_smoke_config(ARCH), 3, device="cpu")
    for mine, theirs in ((fleet.spec.params, ref.spec.params),
                         (fleet.spec.opt, ref.spec.opt)):
        assert mine.offsets == theirs.offsets and mine.sizes == theirs.sizes
        assert mine.shapes == theirs.shapes
        assert [str(d).replace("torch.", "") for d in mine.dtypes] \
            == list(theirs.dtypes)
    assert list(fleet.spec.params.keys) == _paths(r_params)
    assert fleet.model_bytes == ref.model_bytes
    fleet.pbuf, fleet.obuf = T_FS.fleet_from_reference(
        np.asarray(ref.pbuf), np.asarray(ref.obuf), fleet.spec, "cpu")
    for (path, got), want in zip(tree_paths(fleet.stacked_params),
                                 jax.tree.leaves(r_params)):
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), path
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype("float32")))


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-4),
                                        ("bfloat16", 1e-2)])
def test_federation_matches_reference(dtype, tol):
    jax = pytest.importorskip("jax")
    from repro.core.protocol import DySTop as R_DySTop
    from repro.dfl import lm_worker as R_LW
    from repro.models import registry as R_R
    r_cfg = dataclasses.replace(R_R.get_smoke_config(ARCH), dtype=dtype)
    with jax.default_device(jax.devices("cpu")[0]):
        init = R_LW.init_fleet(r_cfg, KW["n_workers"], seed=KW["seed"])
        _, r_hist = R_LW.run_lm_federation(
            R_DySTop(V=3.0, t_thre=10, max_neighbors=3), r_cfg,
            R_LW.LMRunConfig(**KW))
    cfg = dataclasses.replace(T_R.get_smoke_config(ARCH), dtype=dtype)
    _, hist = T_LW.run_lm_federation(
        _mech(), cfg, T_LW.LMRunConfig(**KW), device="cpu",
        init=(np.asarray(init.pbuf), np.asarray(init.obuf)))
    for f in CONTROL:
        assert getattr(hist, f) == getattr(r_hist, f), f
    assert max(hist.round_active) > 1       # some rounds train several rows
    assert np.isfinite(hist.loss_global).all()
    np.testing.assert_allclose(hist.loss_global, r_hist.loss_global,
                               atol=tol, rtol=0)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
def test_cuda_ssd_chunk_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    assert not torch.backends.cuda.matmul.allow_tf32   # IEEE f32 plain
    dev = torch.device("cuda")
    before = T_SC.launches
    # the path's shape, the smoke shape, ragged Q (200, 100, 1, 300), H that
    # no head grouping divides, N not a multiple of the 32-column stage, and
    # every P; a large dt whose masked exponents pass 88
    cases = [((8, 80, 256, 128, 64), 0.1), ((4, 16, 32, 32, 32), 0.1),
             ((2, 3, 200, 40, 16), 0.1), ((2, 9, 256, 128, 128), 2.0),
             ((3, 7, 100, 30, 32), 0.1), ((1, 5, 512, 64, 128), 0.05),
             ((2, 3, 1, 8, 16), 0.1), ((1, 11, 300, 128, 64), 0.1)]
    for (g, h, q, n, p), rate in cases:
        ins = [a.to(dev) for a in _t(*_ssd_inputs(q + p, g, h, q, n, p,
                                                  rate))]
        got = T_SC.ssd_chunk(*ins)
        want = T_SC.ssd_chunk_plain(*ins)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    # xbar whose base is 4 bytes off 16 (4-byte copies instead of 16)
    Bc, Cc, la, xb = (a.to(dev) for a in _t(*_ssd_inputs(7, 2, 4, 96, 32,
                                                          64)))
    flat = torch.empty((xb.numel() + 1,), device=dev)
    xb_off = flat[1:].view(xb.shape)
    xb_off.copy_(xb)
    torch.testing.assert_close(T_SC.ssd_chunk(Bc, Cc, la, xb_off),
                               T_SC.ssd_chunk_plain(Bc, Cc, la, xb),
                               atol=2e-4, rtol=2e-4)
    # the model's layout: head-major views of (G, Q, H, .) tensors
    Bc, Cc, la, xb = (a.to(dev) for a in _t(*_ssd_inputs(5, 4, 10, 64, 32,
                                                          64)))
    la_v = la.transpose(1, 2).contiguous().transpose(1, 2)
    xb_v = xb.transpose(1, 2).contiguous().transpose(1, 2)
    got = T_SC.ssd_chunk(Bc, Cc, la_v, xb_v)
    assert got.stride() == xb_v.stride()
    torch.testing.assert_close(got, T_SC.ssd_chunk_plain(Bc, Cc, la, xb),
                               atol=2e-4, rtol=2e-4)
    # cum_la that rises: a falling wave that rises in places, and a spike to
    # 100 at q = 64, where a decay split at the tile's first row would
    # overflow in rows whose plain values are finite (only the spike's own
    # rows are not)
    Bc, Cc, _, xb = (a.to(dev) for a in _t(*_ssd_inputs(3, 2, 8, 256, 128,
                                                          64)))
    qs = np.arange(256, dtype=np.float32)
    wave = np.broadcast_to(np.sin(qs / 8) - 0.08 * qs, (2, 8, 256)).copy()
    spike = np.zeros((2, 8, 256), np.float32)
    spike[..., 64], spike[..., 65:] = 100.0, -2.0 - 0.08 * (qs[65:] - 64)
    for la, n_bad in ((wave, 0), (spike, 16)):
        la = torch.from_numpy(la).to(dev)
        got = T_SC.ssd_chunk(Bc, Cc, la, xb)
        want = T_SC.ssd_chunk_plain(Bc, Cc, la, xb)
        rows = torch.isfinite(want).all(-1)
        assert int((~rows).sum()) == n_bad
        assert torch.isfinite(got[rows]).all()
        torch.testing.assert_close(got[rows], want[rows], atol=2e-4,
                                   rtol=2e-4)
    assert T_SC.launches - before == len(cases) + 4

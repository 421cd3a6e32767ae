"""The port's two kernels, held against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held here
against the Pallas kernels run in interpret mode and the JAX package's own
oracles, on the same numpy inputs, with jax on its CPU backend (a GPU
backend would multiply f32 in reduced precision).  The CUDA kernels
themselves run only on a card: ``test_cuda_kernels_match_plain_versions``
(marker ``cuda``) holds each against its plain version there and skips
elsewhere.  Tests that need the JAX package import it inside the test, so
this file also runs on a machine without jax.
"""
import numpy as np
import pytest
import torch

from repro_torch.dfl import flat_state as T_FS
from repro_torch.kernels import aggregate as T_AGG
from repro_torch.kernels import fused_sgd as T_FSGD

N, P = 24, 200


def _agg_inputs(seed, k, u, col):
    """W rows like the packer's: column-sparse with padding columns that
    repeat index 0 and carry zero weight (u < N), or u = N (arange)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, P)).astype(np.float32)
    if col and u < N:
        ut = max(1, (2 * u) // 3)
        cols = np.sort(rng.choice(N, ut, replace=False))
        col_ids = np.concatenate([cols, np.zeros(u - ut, cols.dtype)])
        W = rng.random((k, u)).astype(np.float32)
        W[:, ut:] = 0.0
    else:
        col_ids = np.arange(N) if col else None
        W = rng.random((k, N)).astype(np.float32)
    W /= W.sum(1, keepdims=True)
    return W, X, None if col_ids is None else col_ids.astype(np.int32)


@pytest.mark.parametrize("k", [8, 16, N])
@pytest.mark.parametrize("u, col", [(8, True), (16, True), (N, True),
                                    (N, False)])
def test_aggregate_plain_matches_pallas(k, u, col):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import aggregate as R_AGG
    from repro.kernels import ref as R_REF
    W, X, cid = _agg_inputs(k * 100 + u, k, u, col)
    got = T_AGG.aggregate(torch.from_numpy(W), torch.from_numpy(X),
                          None if cid is None else torch.from_numpy(cid))
    with jax.default_device(jax.devices("cpu")[0]):   # full f32 products
        if col:
            pallas = R_AGG.aggregate_rows_cols(
                jnp.asarray(W), jnp.asarray(cid), jnp.asarray(X), p_blk=128,
                interpret=True)
            oracle = R_REF.aggregate_rows_cols_ref(W, cid, X)
        else:
            pallas = R_AGG.aggregate_rows(jnp.asarray(W), jnp.asarray(X),
                                          p_blk=128, interpret=True)
            oracle = R_REF.aggregate_ref(W, X)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=1e-5,
                               rtol=1e-5)


def test_aggregate_checks_its_inputs():
    W = torch.ones((2, 3))
    with pytest.raises(ValueError, match="k = 0"):
        T_AGG.aggregate(torch.ones((0, 3)), torch.ones((3, 5)))
    with pytest.raises(ValueError, match="does not contract"):
        T_AGG.aggregate(W, torch.ones((4, 5)))
    with pytest.raises(ValueError, match="col_ids must be"):
        T_AGG.aggregate(W, torch.ones((4, 5)), torch.zeros(2, dtype=torch.int32))


def _sgd_inputs(seed, k, steps, batch, dim=6, hidden=12, classes=5):
    rng = np.random.default_rng(seed)
    stacked = {
        "w1": rng.normal(size=(k, dim, hidden)) * dim ** -0.5,
        "b1": rng.normal(size=(k, hidden)) * 0.1,
        "w2": rng.normal(size=(k, hidden, hidden)) * hidden ** -0.5,
        "b2": rng.normal(size=(k, hidden)) * 0.1,
        "w3": rng.normal(size=(k, hidden, classes)) * hidden ** -0.5,
        "b3": rng.normal(size=(k, classes)) * 0.1}
    stacked = {n: v.astype(np.float32) for n, v in stacked.items()}
    xb = rng.normal(size=(k, steps, batch, dim)).astype(np.float32)
    yb = rng.integers(0, classes, size=(k, steps, batch)).astype(np.int32)
    active = (np.arange(k) % 3 != 1).astype(np.float32)   # a third idle
    return stacked, xb, yb, active


@pytest.mark.parametrize("k, steps, batch", [(8, 2, 8), (5, 1, 4),
                                             (16, 3, 6)])
@pytest.mark.parametrize("with_losses", [True, False])
def test_fused_sgd_plain_matches_pallas(k, steps, batch, with_losses):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.dfl import flat_state as R_FS
    from repro.dfl import worker as R_WK
    from repro.kernels import fused_sgd as R_FSGD
    stacked, xb, yb, active = _sgd_inputs(k * 10 + steps, k, steps, batch)
    buf, spec = T_FS.from_reference(stacked, "cpu")
    lr = 0.1
    out, loss = T_FSGD.fused_sgd(buf, torch.from_numpy(xb),
                                 torch.from_numpy(yb),
                                 torch.from_numpy(active), spec, lr,
                                 with_losses=with_losses)
    with jax.default_device(jax.devices("cpu")[0]):   # full f32 products
        r_buf, r_spec = R_FS.flatten_stacked(stacked)
        args = (r_buf, jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(active))
        p_out, p_loss = R_FSGD.fused_sgd(*args, r_spec, lr,
                                         with_losses=with_losses,
                                         interpret=True)
        j_out, j_loss = R_WK.local_sgd_flat_fused(*args, r_spec, lr,
                                                  with_losses=with_losses)
    for ref_out, ref_loss in ((p_out, p_loss), (j_out, j_loss)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss),
                                   atol=1e-5, rtol=0)
    idle = active == 0
    np.testing.assert_array_equal(out.numpy()[idle], np.asarray(r_buf)[idle])
    if with_losses:
        assert np.all(loss.numpy()[idle] > 0)      # idle rows still report
    else:
        np.testing.assert_array_equal(loss.numpy(), 0.0)


def test_fused_sgd_checks_its_inputs():
    stacked, xb, yb, active = _sgd_inputs(0, 4, 2, 3)
    buf, spec = T_FS.from_reference(stacked, "cpu")
    x, y, a = (torch.from_numpy(v) for v in (xb, yb, active))
    with pytest.raises(ValueError, match="k = 0"):
        T_FSGD.fused_sgd(buf[:0], x[:0], y[:0], a[:0], spec, 0.1)
    with pytest.raises(ValueError, match="expected xb"):
        T_FSGD.fused_sgd(buf, x[:, 0], y, a, spec, 0.1)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    before = (T_AGG.launches, T_FSGD.launches)
    n_agg = 0
    for k, u, col in [(8, 8, True), (16, N, True), (N, N, False),
                      (32, 16, True), (64, N, True)]:
        W, X, cid = (None if a is None else torch.from_numpy(a).to(dev)
                     for a in _agg_inputs(k + u, k, u, col))
        got = T_AGG.aggregate(W, X, cid)
        torch.testing.assert_close(got, T_AGG.aggregate_plain(W, X, cid),
                                   atol=1e-5, rtol=1e-5)
        n_agg += 1
    # more columns of W than one shared-memory tile holds (n_in > 128)
    g = torch.Generator().manual_seed(0)
    W = torch.rand((20, 300), generator=g).to(dev) / 300
    X = torch.randn((300, 777), generator=g).to(dev)
    torch.testing.assert_close(T_AGG.aggregate(W, X),
                               T_AGG.aggregate_plain(W, X),
                               atol=1e-5, rtol=1e-5)
    n_agg += 1
    # k in {32, 64, 100, 128, 200} and P % 4 in {0, 1, 2, 3} (the load width
    # follows P and the base); the widths give the same bits
    for k in (32, 64, 100, 128, 200):
        W = torch.rand((k, 100), generator=g).to(dev) / 100
        X = torch.randn((100, 6924), generator=g).to(dev)
        wide = T_AGG.aggregate(W, X)
        n_agg += 1
        for p in (6920, 6921, 6922, 6923):
            Xp = X[:, :p].contiguous()
            got = T_AGG.aggregate(W, Xp)
            n_agg += 1
            torch.testing.assert_close(got, T_AGG.aggregate_plain(W, Xp),
                                       atol=1e-5, rtol=1e-5)
            assert torch.equal(got.view(torch.int32),
                               wide[:, :p].view(torch.int32)), (k, p)
    # a base 4 bytes off 16 (4-byte copies), and an index outside [0, N)
    flat = torch.randn((100 * 6920 + 1,), generator=g).to(dev)
    X = flat[1:].view(100, 6920)
    cid = torch.arange(100, dtype=torch.int32, device=dev)
    for k in (8, 100):
        W = torch.rand((k, 100), generator=g).to(dev) / 100
        torch.testing.assert_close(T_AGG.aggregate(W, X, cid),
                                   T_AGG.aggregate_plain(W, X, cid),
                                   atol=1e-5, rtol=1e-5)
        bad = cid.clone()
        bad[7] = 100
        assert torch.isnan(T_AGG.aggregate(W, X, bad)).all()
        n_agg += 2
    # the sim defaults, and hidden = 128: 167 KB of row, minibatches and
    # activations per CTA (the row stays in shared memory)
    for with_losses, hidden in ((True, 64), (False, 64), (True, 128)):
        stacked, xb, yb, active = _sgd_inputs(3, 16, 2, 32, dim=32,
                                              hidden=hidden, classes=10)
        buf, spec = T_FS.from_reference(stacked, dev)
        x, y, a = (torch.from_numpy(v).to(dev) for v in (xb, yb, active))
        out, loss = T_FSGD.fused_sgd(buf, x, y, a, spec, 0.05, with_losses)
        ref, ref_loss = T_FSGD.local_sgd_flat_fused(buf, x, y, a, spec, 0.05,
                                                    with_losses)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
        torch.testing.assert_close(loss, ref_loss, atol=1e-4, rtol=0)
        assert torch.equal(out[a == 0], buf[a == 0])
    assert (T_AGG.launches - before[0],
            T_FSGD.launches - before[1]) == (n_agg, 3)


# --------------------------------------------------------------------------- #
# flash attention (kernel row 4)
# --------------------------------------------------------------------------- #

from repro_torch.kernels import flash_attention as T_FA  # noqa: E402
from repro_torch.kernels import ops as T_OPS  # noqa: E402
from repro_torch.kernels import ref as T_REF  # noqa: E402

_BF16_MANTISSA = 7


def _bf16_ulps(got, want, f32_atol=1e-6):
    """Elementwise distance in bf16 ulps of the larger magnitude, after
    ``f32_atol``: both sides sum in f32 in different orders before one
    rounding to bf16, and near 0 (|o| ~ 1e-6) that f32 noise is itself
    several bf16 ulps of the tiny value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126)))
                  - _BF16_MANTISSA)
    return np.maximum(np.abs(got - want) - f32_atol, 0.0) / ulp


def _bf16_truncate(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the bf16 value that keeps its top 16 bits (rounding to 0)."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _kernel_rounding(q, k, v, causal=True, window=None, softcap=None,
                     p_parts=3, tile=64):
    """The bf16 CUDA flash kernel's arithmetic in plain torch, rounding
    place by rounding place, for bf16 (B, H, S, D) q and (B, Hk, S, D) k, v.

    bf16 q . k products (exact in f32) summed in f32; the scores softcapped
    (tanh(s (D^-1/2 / c)) c) or left raw with D^-1/2 moved into the
    exponent's coefficient; the masks; an online softmax over ``tile``-column
    tiles in base 2 (p = 2^fma(s, coef, -M), M the row's running max times
    coef, alpha = 2^(M_old - M_new)); and each tile's P kept as ``p_parts``
    bf16 parts, each multiplied by bf16 v (exact) into one f32 accumulator.
    The kernel keeps three (hi and mid truncated, lo rounded from the exact
    remainder: ~24 bits); ``p_parts`` = 1 rounds P to bf16 once, as a
    single-product kernel would, and 2 keeps hi truncated and lo rounded.
    It pins the numeric argument the kernel rests on."""
    if p_parts not in (1, 2, 3):
        raise ValueError(f"p_parts must be 1, 2 or 3, got {p_parts}")
    b, h, s, d = q.shape
    g = h // k.shape[1]
    q = q.float()
    k = k.repeat_interleave(g, dim=1).float()
    v = v.repeat_interleave(g, dim=1).float()
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    coef = log2e if softcap is not None else scale * log2e
    rows = torch.arange(s)[:, None]
    m = torch.full((b, h, s, 1), T_REF.NEG_INF)
    big_m = torch.zeros((b, h, s, 1))
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, tile):
        kt, vt = k[:, :, k0:k0 + tile], v[:, :, k0:k0 + tile]
        sc = q @ kt.transpose(-1, -2)
        if softcap is not None:
            cap_scale = scale * (1.0 / torch.tensor(softcap,
                                                    dtype=torch.float32))
            sc = torch.tanh(sc * cap_scale) * softcap
        cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
        keep = torch.ones((s, kt.shape[2]), dtype=torch.bool)
        if causal:
            keep &= cols <= rows
        if window is not None:
            keep &= (rows - cols) < window
        sc = torch.where(keep, sc, T_REF.NEG_INF)
        mx = torch.maximum(m, sc.amax(-1, keepdim=True))
        none = mx == T_REF.NEG_INF
        m_new = mx * coef
        alpha = torch.where(none, 1.0, torch.where(
            m == T_REF.NEG_INF, 0.0, torch.exp2(big_m - m_new)))
        big_m = torch.where(none, big_m, m_new)
        m_use = torch.where(none, 0.0, m_new)
        arg = (sc.double() * coef.double() - m_use.double()).float()  # fma
        p = torch.exp2(arg)
        m = mx
        l = alpha * l + p.sum(-1, keepdim=True)
        if p_parts == 1:
            parts = [p.bfloat16().float()]
        else:
            hi = _bf16_truncate(p)
            parts = [hi]
            rest = p - hi
            if p_parts == 3:
                parts.append(_bf16_truncate(rest))
                rest = rest - parts[-1]
            parts.append(rest.bfloat16().float())
        pv = sum(part @ vt for part in reversed(parts))   # smallest first
        acc = acc * alpha + pv
    return (acc / l.clamp_min(1e-30)).bfloat16()



def _qkv(seed, b, h, s, d, hk=None):
    rng = np.random.default_rng(seed)
    hk = hk or h
    return (rng.normal(size=(b, h, s, d)).astype(np.float32),
            rng.normal(size=(b, hk, s, d)).astype(np.float32),
            rng.normal(size=(b, hk, s, d)).astype(np.float32))


# (B, H, S, causal, window, softcap[, D]): ragged S = 100 and 160 cut the
# reference's 128-row tiles; window and softcap as the gemma2 layers use them;
# D = 64 unless given: kimi-k2's 112 and the smoke configs' 32, which the bf16
# kernel pads to 128 and 64 columns in shared memory
_FLASH_CASES = [(2, 4, 128, True, None, None), (1, 3, 100, True, None, None),
                (2, 2, 160, True, 48, None), (1, 4, 96, True, None, 30.0),
                (2, 2, 64, False, None, None), (1, 2, 160, False, 40, 50.0),
                (1, 2, 100, True, None, None, 112),
                (2, 2, 72, True, 24, 20.0, 32)]


@pytest.mark.parametrize("case", _FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(case, dtype):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import flash_attention as R_FA
    from repro.kernels import ref as R_REF
    b, h, s, causal, window, softcap, *d = case
    q, k, v = _qkv(b * 1000 + s, b, h, s, d[0] if d else 64)
    tdt = getattr(torch, dtype)
    got = T_FA.flash_attention(*(torch.from_numpy(a).to(tdt)
                                 for a in (q, k, v)),
                               causal=causal, window=window, softcap=softcap)
    with jax.default_device(jax.devices("cpu")[0]):
        qj, kj, vj = (jnp.asarray(a, dtype) for a in (q, k, v))
        pallas = R_FA.flash_attention(qj, kj, vj, causal=causal,
                                      window=window, softcap=softcap,
                                      interpret=True)
        oracle = R_REF.flash_attention_ref(qj, kj, vj, causal=causal,
                                           window=window, softcap=softcap)
    got = got.float().numpy()
    for want in (pallas, oracle):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:       # f32 sums in another order, one rounding to bf16
            assert _bf16_ulps(got, want).max() <= 1.0


def test_flash_plain_reads_gqa_heads_in_place():
    """k/v with Hk < H heads: query head h reads kv head h // (H // Hk),
    the model's order, equal to repeating the kv heads (the reference)."""
    q, k, v = _qkv(7, 2, 6, 80, 64, hk=2)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    rep = [t[0]] + [x.repeat_interleave(3, dim=1) for x in t[1:]]
    np.testing.assert_array_equal(T_FA.flash_attention(*t).numpy(),
                                  T_FA.flash_attention(*rep).numpy())


@pytest.mark.parametrize("causal, window, softcap",
                         [(True, None, None), (True, 24, 20.0),
                          (False, None, None)])
def test_flash_diff_gradient_matches_jax_vjp(causal, window, softcap):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as R_OPS
    from repro.kernels.config import KernelConfig
    q, k, v = _qkv(11, 2, 2, 72, 64)
    g = np.random.default_rng(12).normal(size=q.shape).astype(np.float32)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = T_OPS.flash_attention_diff(*t, causal=causal, window=window,
                                     softcap=softcap)
    grads = torch.autograd.grad(out, t, torch.from_numpy(g))
    with jax.default_device(jax.devices("cpu")[0]):
        kc = KernelConfig(backend="pallas")
        j_out, pullback = jax.vjp(
            lambda a, b_, c: R_OPS.flash_attention_diff(
                a, b_, c, kc, causal=causal, window=window, softcap=softcap),
            *(jnp.asarray(a) for a in (q, k, v)))
        j_grads = pullback(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=1e-5, rtol=0)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


def test_flash_fully_masked_rows_are_zero():
    """A window <= 0 masks every column of a causal row: the output is 0
    (the kernel's acc / max(l, 1e-30)), not NaN and not an average."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 2, 50, 64))
    assert torch.equal(T_FA.flash_attention(q, k, v, window=0),
                       torch.zeros_like(q))
    out = T_FA.flash_attention(q, k, v, causal=False, window=-10)
    assert torch.equal(out[:, :, -11:], torch.zeros_like(out[:, :, -11:]))
    assert torch.isfinite(out).all() and out[:, :, :-11].abs().sum() > 0


def test_flash_checks_its_inputs():
    q = torch.zeros((1, 4, 8, 64))
    with pytest.raises(ValueError, match="do not group"):
        T_FA.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError, match="must be \\(B, Hk, S, D\\)"):
        T_FA.flash_attention(q, q[:, :, :4], q[:, :, :4])
    # bf16 (TMA pads D in shared memory): any multiple of 8 up to 256
    for d in (8, 32, 96, 112, 256):
        T_FA.check_sizes(1, 4, 8, d, torch.bfloat16)
    for d in (100, 264):
        with pytest.raises(ValueError, match="head_dim"):
            T_FA.check_sizes(1, 4, 8, d, torch.bfloat16)
    # f32 (the CUDA-core kernel's template instances): 64, 128, 256 only
    with pytest.raises(ValueError, match="head_dim"):
        T_FA.check_sizes(1, 4, 8, 96, torch.float32)
    with pytest.raises(ValueError, match="32-bit row"):
        T_FA.check_sizes(1, 4, 2 ** 31 - 10, 64, torch.bfloat16)
    # bf16's grid is 1-D: B past the old 65,535 (grid z) is taken; f32's is not
    T_FA.check_sizes(70_000, 4, 8, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="grid"):
        T_FA.check_sizes(70_000, 4, 8, 64, torch.float32)
    with pytest.raises(ValueError, match="32-bit grid"):
        T_FA.check_sizes(2 ** 20, 2 ** 11, 64, 64, torch.bfloat16)
    T_FA.check_sizes(4, 9, 256, 64, torch.bfloat16)
    T_FA.check_sizes(4, 9, 256, 64, torch.float32)
    with pytest.raises(ValueError, match="f32 or bf16"):
        T_FA.check_sizes(4, 9, 256, 64, torch.float16)


@pytest.mark.parametrize("shift, strides, ok", [
    (0, (9 * 256 * 64, 64, 9 * 64, 1), True),     # the model's (B, S, H, D)
    (0, (4 * 8 * 112, 8 * 112, 112, 1), True),     # D = 112, contiguous
    (2, (9 * 256 * 64, 64, 9 * 64, 1), False),     # base off by one bf16
    (0, (4 * 8 * 65, 8 * 65, 65, 1), False),       # rows 130 bytes apart
    (0, (4 * 8 * 64, 8 * 64, 64, 2), False)])      # D not contiguous
def test_flash_bf16_alignment_check(shift, strides, ok):
    """TMA reads 16-byte-aligned bases and strides only: the wrapper raises
    on a bf16 CUDA call that lacks them, and never falls back.  Strides of
    dimensions of extent 1 are never stepped and are not checked."""
    shape = (2, 9, 256, 64)
    if ok:
        T_FA.check_alignment("q", 0x7F0000000000 + shift, shape, strides, 2)
    else:
        with pytest.raises(ValueError, match="16|contiguous"):
            T_FA.check_alignment("q", 0x7F0000000000 + shift, shape,
                                 strides, 2)
    T_FA.check_alignment("q", 0x7F0000000000, (1, 1, 1, 64), (3, 5, 7, 1), 2)


# (B, H, S, D, Hk), causal, window, softcap: the shapes at which the kernel's
# rounding places are held to the 2-ulp gate.  Short causal rows (S = 16)
# give P few, large terms, where a part's rounding error is largest.
_P_PART_CASES = [((4, 9, 256, 64, 3), True, None, None),     # the LM path
                 ((1, 4, 256, 128, 2), True, None, None),    # D^-1/2 not 2^n
                 ((1, 2, 256, 256, 1), True, 100, 50.0),     # gemma2's D
                 ((500, 1, 16, 64, 1), True, None, None)]    # S = 16 rows


@pytest.mark.parametrize("shape, causal, window, softcap", _P_PART_CASES,
                         ids=["path-d64", "d128", "d256-softcap", "s16-rows"])
def test_flash_bf16_split_p_rounding_within_two_ulps(shape, causal, window,
                                                     softcap):
    """The numeric argument the bf16 kernel rests on: with P kept as three
    bf16 parts (~24 bits) its rounding places stay within the 2-bf16-ulp
    gate of the f32 plain version on the same bf16 inputs.  P rounded to one
    bf16 part, as a single-product kernel would, or kept as two (~16 bits,
    2^-18 relative per term) moves outputs near 0 past the gate on the short
    rows.  Prints the worst distance for 1, 2 and 3 parts (``pytest -s``)."""
    b, h, s, d, hk = shape
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(s + d, b, h, s, d, hk=hk))
    want = T_FA.flash_attention_plain(q, k, v, causal, window, softcap)
    worst = [float(_bf16_ulps(_kernel_rounding(
        q, k, v, causal, window, softcap, p_parts=n).float().numpy(),
        want.float().numpy()).max()) for n in (1, 2, 3)]
    print(f"{shape} window={window} softcap={softcap}: worst bf16 ulps with "
          f"1, 2, 3 parts of P: {worst}")
    assert worst[2] <= 2.0, worst
    if s == 16:
        assert worst[0] > 100 and worst[1] > 2.0, worst


@pytest.mark.parametrize("k, p, ok", [
    (8, 2 ** 31 - 128, True),
    (8, 2 ** 31 - 127, True),
    (8, 2_614_341_888, True),          # gemma2-2b's full-depth P
    (100, 2_614_341_888, True),
    (8, 128 * (2 ** 31 - 1), True),    # the most blocks of p_blk = 128
    (8, 128 * (2 ** 31 - 1) + 1, False)])
def test_aggregate_rejects_columns_past_32_bits(k, p, ok):
    """Columns are 64-bit, so P past 2^31 (full-depth fleets such as
    gemma2-2b's ~2.6e9) is taken; only a grid of more than 2^31 - 1 column
    blocks is refused."""
    if ok:
        T_AGG.check_sizes(k, 16, 8, p, 128)
    else:
        with pytest.raises(ValueError, match="blocks of 128"):
            T_AGG.check_sizes(k, 16, 8, p, 128)


def test_aggregate_row_limits_and_devices():
    """The grid holds 65,535 blocks of 8 rows, k, n_in and N are C ints, and
    a tensor on neither the CPU nor a card is refused: the kernel never
    falls back to the plain version there."""
    T_AGG.check_sizes(8 * 65535, 8, 8, 64, 128)
    with pytest.raises(ValueError, match="row blocks"):
        T_AGG.check_sizes(8 * 65535 + 1, 8, 8, 64, 128)
    with pytest.raises(ValueError, match="C int"):
        T_AGG.check_sizes(8, 2 ** 31, 8, 64, 128)
    with pytest.raises(ValueError, match="P=0"):
        T_AGG.check_sizes(8, 8, 8, 0, 128)
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        T_AGG.aggregate(_on_xpu(torch.ones((2, 3))),
                        _on_xpu(torch.ones((3, 5))))
    # meta has no data: an empty output of the right shape
    out = T_AGG.aggregate(torch.ones((2, 3), device="meta"),
                          torch.ones((3, 5), device="meta"))
    assert (out.device.type, out.shape, out.dtype) == ("meta", (2, 5),
                                                       torch.float32)


class _Xpu(torch.Tensor):
    """A tensor that says it lies on a device with no kernel here."""
    @property
    def device(self):
        return torch.device("xpu")


def _on_xpu(t):
    return torch.Tensor._make_subclass(_Xpu, t)


@pytest.mark.cuda
def test_cuda_flash_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    before = T_FA.launches
    cases = [((4, 9, 256, 64, 3), "bfloat16", True, None, None),
             ((1, 4, 200, 64, 4), "float32", True, None, None),
             ((2, 4, 160, 128, 2), "float32", True, 64, 50.0),
             ((1, 2, 130, 256, 2), "bfloat16", False, None, None),
             ((2, 8, 200, 112, 1), "bfloat16", True, None, None),   # kimi-k2
             ((1, 48, 4096, 128, 8), "bfloat16", True, None, None)]  # grok
    for (b, h, s, d, hk), dtype, causal, window, softcap in cases:
        q, k, v = (torch.from_numpy(a).to(dev, getattr(torch, dtype))
                   for a in _qkv(s + d, b, h, s, d, hk=hk))
        got = T_FA.flash_attention(q, k, v, causal, window, softcap)
        want = T_FA.flash_attention_plain(q, k, v, causal, window, softcap)
        if dtype == "float32":
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        else:
            assert _bf16_ulps(got.float().cpu(),
                              want.float().cpu()).max() <= 2.0
    # the model's layout: (B, S, H, D) projections as transposed views
    x = torch.randn((2, 96, 6, 64), device=dev)
    kv = torch.randn((2, 96, 2, 64), device=dev)
    got = T_FA.flash_attention(x.transpose(1, 2), kv.transpose(1, 2),
                               kv.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(
        got, T_FA.flash_attention_plain(x.transpose(1, 2), kv.transpose(1, 2),
                                        kv.transpose(1, 2)),
        atol=1e-5, rtol=0)
    assert T_FA.launches - before == 7

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
    for k, u, col in [(8, 8, True), (16, N, True), (N, N, False)]:
        W, X, cid = (None if a is None else torch.from_numpy(a).to(dev)
                     for a in _agg_inputs(k + u, k, u, col))
        got = T_AGG.aggregate(W, X, cid)
        torch.testing.assert_close(got, T_AGG.aggregate_plain(W, X, cid),
                                   atol=1e-5, rtol=1e-5)
    # more columns of W than one shared-memory tile holds (n_in > 128)
    g = torch.Generator().manual_seed(0)
    W = torch.rand((20, 300), generator=g).to(dev) / 300
    X = torch.randn((300, 777), generator=g).to(dev)
    torch.testing.assert_close(T_AGG.aggregate(W, X),
                               T_AGG.aggregate_plain(W, X),
                               atol=1e-5, rtol=1e-5)
    # the sim defaults, and hidden = 256: 136 KB of activations per block
    for with_losses, hidden in ((True, 64), (False, 64), (True, 256)):
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
    assert (T_AGG.launches - before[0], T_FSGD.launches - before[1]) == (4, 3)

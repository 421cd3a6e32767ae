"""The port's flat (N, P) buffer is the JAX package's, column for column:
a reference buffer round-trips bit-exactly through the port."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.dfl import flat_state as R_FS  # noqa: E402
from repro.dfl import worker as R_WK  # noqa: E402
from repro_torch.dfl import flat_state as T_FS  # noqa: E402
from repro_torch.dfl import worker as T_WK  # noqa: E402


def _reference(n=6, dim=5, hidden=7, classes=3, seed=0):
    stacked = R_WK.init_stacked(jax.random.PRNGKey(seed), n, dim, hidden,
                                classes)
    rng = np.random.default_rng(seed)
    # distinct rows and nonzero biases, so a misplaced column shows
    stacked = {k: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32)
               for k, v in stacked.items()}
    buf, spec = R_FS.flatten_stacked(stacked)
    return stacked, np.asarray(buf), spec


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_buffer_roundtrips_bit_exactly(seed):
    stacked, ref_buf, ref_spec = _reference(seed=seed)
    buf, spec = T_FS.from_reference(stacked, "cpu")
    np.testing.assert_array_equal(buf.numpy(), ref_buf)
    assert spec.offsets == ref_spec.offsets and spec.sizes == ref_spec.sizes
    assert spec.shapes == ref_spec.shapes and spec.n_params == ref_spec.n_params
    tree = T_FS.unflatten(buf, spec)
    for k, v in stacked.items():
        np.testing.assert_array_equal(tree[k].numpy(), v)
    again, _ = T_FS.flatten_stacked(tree)
    np.testing.assert_array_equal(again.numpy(), ref_buf)
    row = T_FS.unravel_row(buf[2], spec)
    np.testing.assert_array_equal(T_FS.ravel_row(row, spec).numpy(),
                                  ref_buf[2])


def test_column_order_is_the_references():
    stacked, ref_buf, ref_spec = _reference()
    _, spec = T_FS.from_reference(stacked, "cpu")
    assert spec.keys == ("b1", "b2", "b3", "w1", "w2", "w3")
    ref_keys = [path[0].key for path, _ in
                jax.tree_util.tree_flatten_with_path(stacked)[0]]
    assert tuple(ref_keys) == spec.keys
    assert T_WK.fused_sgd_supported(spec)


def test_weighted_row_matches_reference():
    stacked, ref_buf, _ = _reference(n=9)
    buf, _ = T_FS.from_reference(stacked, "cpu")
    alpha = np.random.default_rng(4).dirichlet(np.ones(9)).astype(np.float32)
    want = np.asarray(R_FS.weighted_row(jax.numpy.asarray(ref_buf),
                                        jax.numpy.asarray(alpha)))
    got = T_FS.weighted_row(buf, torch.from_numpy(alpha)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # a one-hot weighting picks a row out bit for bit
    onehot = torch.zeros(9)
    onehot[5] = 1.0
    np.testing.assert_array_equal(T_FS.weighted_row(buf, onehot).numpy(),
                                  ref_buf[5])


def test_model_bytes_match_reference():
    stacked, _, _ = _reference()
    buf, spec = T_FS.from_reference(stacked, "cpu")
    ref = R_WK.param_bytes(jax.tree.map(lambda l: l[0], stacked))
    assert T_WK.param_bytes(T_FS.unravel_row(buf[0], spec)) == ref

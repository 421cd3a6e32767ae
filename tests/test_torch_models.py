"""The port's dense decoder, held against the JAX package's.

The reference's own init goes through both packages; ``compute_loss`` and its
gradients are compared with the reference routing attention through its
Pallas flash kernel in interpret mode (``KernelConfig(backend="pallas")``),
jax pinned to its CPU backend.  In f32 the two compute the same algorithm:
loss to 1e-5, gradients to 1e-4.  In bf16 (smollm-135m, smollm-360m,
stablelm-1.6b and gemma2-2b at token seed 5) the tolerances are those of
``tests/test_kernel_plane.py``: loss 2e-3, gradients atol 5e-3 and rtol
5e-2; measured at seed 5: loss 1.7e-4, 1.6e-3, 5.7e-4 and 3.1e-4, every
gradient within 0.16 of its tolerance.

What the scalar bf16 bound can and cannot catch.  The loss gap against the
reference moves with the token seed: over seeds 5-10 it spans 1.7e-4 to 1.5e-3 (smollm-135m), 4.2e-5 to 2.15e-3
(smollm-360m: seed 9 is past 2e-3), 1.3e-4 to 1.95e-3 (stablelm-1.6b)
and 1.1e-4 to 7.1e-4 (gemma2-2b); the
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

from repro_torch.models import registry as T_R
from repro_torch.tree import tree_paths

B, S = 2, 64


def _reference(arch, dtype, seq):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.config import KernelConfig
    from repro.models import registry as R_R
    cfg = dataclasses.replace(R_R.get_smoke_config(arch), dtype=dtype)
    pal = dataclasses.replace(cfg, kernels=KernelConfig(backend="pallas"))
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, size=(B, seq)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, size=(B, seq)).astype(np.int32)
    with jax.default_device(jax.devices("cpu")[0]):
        params, _ = R_R.init_params(cfg, jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
                 "loss_mask": jnp.ones((B, seq), jnp.float32)}
        loss, grads = jax.value_and_grad(
            lambda p: R_R.compute_loss(pal, p, batch)[0])(params)
    paths, leaves = zip(*[
        (tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path), l)
        for path, l in jax.tree_util.tree_flatten_with_path(params)[0]])
    return (paths, leaves, float(loss),
            [np.asarray(g.astype(jnp.float32)) for g in jax.tree.leaves(grads)],
            tok, lab)


def _to_torch(paths, leaves):
    """The reference's leaves (bf16 values held exactly in f32) as the
    port's nested tree."""
    from repro_torch.tree import tree_from_paths
    return tree_from_paths(
        (p, torch.from_numpy(np.array(l.astype("float32")))
         .to(getattr(torch, str(l.dtype))))
        for p, l in zip(paths, leaves))


@pytest.mark.parametrize("arch, dtype, seq", [
    ("smollm-135m", "float32", S), ("smollm-135m", "bfloat16", S),
    ("smollm-360m", "float32", S), ("stablelm-1.6b", "float32", S),
    ("gemma2-2b", "float32", 96), ("smollm-360m", "bfloat16", S),
    ("stablelm-1.6b", "bfloat16", S), ("gemma2-2b", "bfloat16", 96)])
def test_compute_loss_and_grads_match_reference(arch, dtype, seq):
    paths, leaves, r_loss, r_grads, tok, lab = _reference(arch, dtype, seq)
    cfg = dataclasses.replace(T_R.get_smoke_config(arch), dtype=dtype)
    params = _to_torch(paths, leaves)
    # same leaves in the same (jax) order: the flat columns line up
    assert [p for p, _ in tree_paths(params)] == list(paths)
    flat = [l.requires_grad_() for _, l in tree_paths(params)]
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
             "loss_mask": torch.ones((B, seq))}
    loss, _ = T_R.compute_loss(cfg, params, batch)
    grads = torch.autograd.grad(loss, flat)
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss.detach()), r_loss,
                               atol=1e-5 if f32 else 2e-3)
    for got, want in zip(grads, r_grads):
        if f32:
            np.testing.assert_allclose(got.float().numpy(), want, atol=1e-4,
                                       rtol=0)
        else:
            np.testing.assert_allclose(got.float().numpy(), want, atol=5e-3,
                                       rtol=5e-2)


def test_init_matches_reference_layout():
    """The port's own init has the reference's leaves, shapes and dtypes in
    the reference's order."""
    jax = pytest.importorskip("jax")
    from repro.models import registry as R_R
    for arch in T_R.DENSE_ARCH_IDS:
        r_cfg = R_R.get_smoke_config(arch)
        with jax.default_device(jax.devices("cpu")[0]):
            r_params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(0))
        t_params = T_R.init_params(T_R.get_smoke_config(arch),
                                   torch.Generator().manual_seed(0))
        got = [(p, tuple(l.shape), str(l.dtype).replace("torch.", ""))
               for p, l in tree_paths(t_params)]
        want = [(tuple(getattr(k, "key", getattr(k, "idx", None))
                       for k in path), tuple(l.shape), str(l.dtype))
                for path, l in jax.tree_util.tree_flatten_with_path(
                    r_params)[0]]
        assert got == want, arch


def test_full_configs_match_reference():
    pytest.importorskip("jax")
    from repro.models import registry as R_R
    for arch in T_R.DENSE_ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            r = dataclasses.asdict(getattr(R_R, get)(arch))
            t = dataclasses.asdict(getattr(T_R, get)(arch))
            r.pop("kernels"), t.pop("kernels")
            assert r == t, (arch, get)

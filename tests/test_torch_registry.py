"""The registry's shape helpers against the JAX package's, for every
architecture at full size and every ``INPUT_SHAPES`` entry.

``batch_specs`` and ``abstract_decode_cache`` answer on the ``meta`` device
(no storage, so the full configs cost nothing); each input and each decode
cache leaf must have the reference's path, shape and dtype.
``long_context_capable`` and ``supported_shapes`` must give the same
answers.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.models import registry as T_R
from repro_torch.tree import tree_paths

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.models import registry as R_R  # noqa: E402

SHAPES = list(INPUT_SHAPES)


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _ref_leaves(tree) -> list:
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             tuple(leaf.shape), np.dtype(leaf.dtype).name)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree) -> list:
    return [(path, tuple(leaf.shape), _dtype(leaf.dtype))
            for path, leaf in tree_paths(tree)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", R_R.ARCH_IDS)
def test_batch_specs_and_decode_cache_match_reference(arch, shape):
    r_cfg, t_cfg = R_R.get_config(arch), T_R.get_config(arch)
    r_spec, t_spec = R_R.INPUT_SHAPES[shape], INPUT_SHAPES[shape]
    got = T_R.batch_specs(t_cfg, t_spec)
    want = R_R.batch_specs(r_cfg, r_spec)
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert (tuple(t.shape), _dtype(t.dtype)) == (
            tuple(want[k].shape), np.dtype(want[k].dtype).name), k
    cache = T_R.abstract_decode_cache(t_cfg, t_spec)
    assert all(leaf.device.type == "meta" for _, leaf in tree_paths(cache))
    assert _port_leaves(cache) == _ref_leaves(
        R_R.abstract_decode_cache(r_cfg, r_spec))


@pytest.mark.parametrize("arch", R_R.ARCH_IDS)
def test_supported_shapes_match_reference(arch):
    r_cfg, t_cfg = R_R.get_config(arch), T_R.get_config(arch)
    assert T_R.long_context_capable(t_cfg) == R_R.long_context_capable(r_cfg)
    assert [s.name for s in T_R.supported_shapes(t_cfg)] == [
        s.name for s in R_R.supported_shapes(r_cfg)]
    for smoke in (T_R.get_smoke_config(arch),):
        assert T_R.long_context_capable(smoke) == R_R.long_context_capable(
            R_R.get_smoke_config(arch))


def test_batch_specs_take_no_storage():
    """A full-size train batch of the largest zoo model: meta tensors, so
    nothing is allocated whatever the shape."""
    spec = T_R.batch_specs(T_R.get_config("kimi-k2-1t-a32b"),
                           INPUT_SHAPES["train_4k"])
    assert spec["tokens"].shape == (256, 4096)
    assert spec["tokens"].dtype == torch.int32
    assert spec["loss_mask"].dtype == torch.float32

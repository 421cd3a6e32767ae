"""The sharding item against the JAX package: analytic parameter counts,
the logical-axes half of init (``registry.param_axes``/
``abstract_params``), the optimizers' ``state_axes``, the logical-axis
rules (``sharding.rules``), the batch and cache axes, the four
``launch.steps.build_*_artifacts`` on the production meshes, ``constrain``,
and ``placements`` against ``NamedSharding`` on 4 gloo ranks.

Every architecture runs at full width: the port's trees live on the
``meta`` device and the reference's under ``jax.eval_shape`` or on
``SR.abstract_mesh``, so nothing is allocated.  Specs compare as tuples.
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

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import mesh as T_MESH
from repro_torch.launch import steps as T_S
from repro_torch.models import registry as T_R
from repro_torch.optim import get_optimizer as t_opt
from repro_torch.sharding import rules as T_SR
from repro_torch.tree import tree_paths
from test_torch_resume import _one_torch_thread  # noqa: F401

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.launch import steps as R_S  # noqa: E402
from repro.models import registry as R_R  # noqa: E402
from repro.optim import get_optimizer as r_opt  # noqa: E402
from repro.sharding import rules as R_SR  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = R_R.ARCH_IDS
SHAPES = list(INPUT_SHAPES)
OPTIMIZERS = ("adam", "sgd", "sgdm_bf16", "adafactor")
# one arch per family: dense, ssm, hybrid, moe, vlm, encdec
FAMILY_ARCHS = ("smollm-135m", "mamba2-2.7b", "recurrentgemma-2b",
                "grok-1-314b", "paligemma-3b", "seamless-m4t-medium")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _port_mesh(name):
    return T_MESH.make_production_mesh(multi_pod=name == "multi")


def _ref_mesh(name):
    return R_SR.abstract_mesh(*MESHES[name])


def _key(k):
    return getattr(k, "key", getattr(k, "idx", None))


def _ref_leaves(tree, is_leaf=None):
    """(path, leaf) of a reference tree, in ``tree_paths`` order."""
    return [(tuple(_key(k) for k in p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


def _sds(tree):
    return [(p, tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in _ref_leaves(tree)]


def _meta(tree):
    return [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tree_paths(tree)]


def _axes_leaf(t):
    return isinstance(t, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in t)


def _ref_specs(tree):
    return [(p, tuple(s.spec)) for p, s in _ref_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]


def _port_specs(tree):
    if type(tree) is tuple:          # a tuple of trees, not one spec
        return [((i,) + p, s) for i, sub in enumerate(tree)
                for p, s in _port_specs(sub)]
    return [(p, tuple(s)) for p, s in tree_paths(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    r_cfg, t_cfg = R_R.get_config(arch), T_R.get_config(arch)
    assert t_cfg.param_count() == r_cfg.param_count()
    assert t_cfg.active_param_count() == r_cfg.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    shapes, axes = R_R.abstract_params(R_R.get_config(arch))
    params, t_axes = T_R.abstract_params(T_R.get_config(arch))
    assert all(t.device.type == "meta" for _, t in tree_paths(params))
    assert _meta(params) == _sds(shapes)
    assert t_axes == axes
    # the axes tree has the params tree's structure, one axis per dim
    ax_paths = tree_paths(t_axes)
    assert [p for p, _ in ax_paths] == [p for p, _ in tree_paths(params)]
    for (_, ax), (_, t) in zip(ax_paths, tree_paths(params)):
        assert len(ax) == t.dim()


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_state_axes_and_init_shapes(name):
    arch = "grok-1-314b"         # shared experts absent, 3-D expert leaves
    r_cfg, t_cfg = R_R.get_config(arch), T_R.get_config(arch)
    shapes, axes = R_R.abstract_params(r_cfg)
    params, t_axes = T_R.abstract_params(t_cfg)
    r, t = r_opt(name), t_opt(name)
    assert t.state_axes(t_axes) == r.state_axes(axes)
    state = t.init(params)
    assert _meta(state) == _sds(jax.eval_shape(r.init, shapes))
    assert all(x.device.type == "meta" for _, x in tree_paths(state))
    if name == "adafactor":      # a factored leaf drops an axis per moment
        mu = t.state_axes(t_axes)["mu"]["blocks"]["p0"]["moe"]["w_gate"]
        assert mu == {"row": ("stack", "experts", "expert_embed"),
                      "col": ("stack", "experts", "expert_mlp")}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_spec_every_param_leaf(mesh):
    t_mesh, r_mesh = _port_mesh(mesh), _ref_mesh(mesh)
    for arch in ARCHS:
        params, axes = T_R.abstract_params(T_R.get_config(arch))
        for (path, ax), (_, t) in zip(tree_paths(axes), tree_paths(params)):
            got = T_SR.logical_spec(ax, t.shape, t_mesh)
            want = R_SR.logical_spec(ax, tuple(t.shape), r_mesh)
            assert isinstance(got, T_SR.PartitionSpec)
            assert tuple(got) == tuple(want), (arch, path)


def test_logical_spec_reference_cases():
    """``tests/test_substrate.py``'s and ``tests/test_perf_features.py``'s
    sharding cases, on the port."""
    m16 = T_MESH.make_production_mesh()
    pod = T_MESH.make_production_mesh(multi_pod=True)
    P = T_SR.PartitionSpec
    # 15 heads don't divide the 16-way model axis -> replicated
    assert T_SR.logical_spec(("embed", "heads", None), (960, 15, 64),
                             m16) == P("data", None, None)
    assert T_SR.logical_spec(("embed", "heads", None), (960, 64, 64),
                             m16) == P("data", "model", None)
    # experts take `model`; expert_mlp must not reuse it
    assert T_SR.logical_spec(("experts", "embed", "expert_mlp"),
                             (384, 7168, 2048), m16) == P("model", "data",
                                                          None)
    # grok: 8 experts don't divide 16 -> expert_mlp takes model instead
    assert T_SR.logical_spec(("experts", "embed", "expert_mlp"),
                             (8, 6144, 32768), m16) == P(None, "data",
                                                         "model")
    assert T_SR.logical_spec(("data", None), (256, 4096), pod) == P(
        ("pod", "data"), None)
    # batch 1 (long_500k): can't shard -> seq takes data
    spec = T_SR.logical_spec(("data", "seq_act", "kv_heads", None),
                             (1, 524288, 4, 256), pod)
    assert spec[0] is None and spec[1] == "data"
    # the moe_contract override
    rules = dict(T_SR.DEFAULT_RULES, moe_contract=("data",))
    assert T_SR.logical_spec(("experts_act", "expert_cap", "moe_contract"),
                             (384, 2560, 7168), m16, rules) == P(
        "model", None, "data")
    assert T_SR.logical_spec(("experts_act", "expert_cap", "moe_contract"),
                             (384, 2560, 7168), m16) == P("model", None, None)
    # the q_seq override (context-parallel attention)
    rules = dict(T_SR.DEFAULT_RULES, q_seq=("model",))
    assert T_SR.logical_spec(("data", "q_seq", "heads", None),
                             (256, 4096, 9, 64), m16, rules) == P(
        "data", "model", None, None)
    spec = T_SR.logical_spec(("data", "q_seq", "heads", None),
                             (256, 4096, 64, 112), m16, rules)
    assert (spec[1] == "model") != (spec[2] == "model")
    # the active context's mesh and rules
    with T_SR.use_sharding_rules(m16, {"q_seq": ("model",)}):
        assert T_SR.active_mesh() is m16
        assert T_SR.logical_spec(("data", "q_seq", "heads", None),
                                 (256, 4096, 9, 64)) == P("data", "model",
                                                          None, None)
    assert T_SR.active_mesh() is None
    with pytest.raises(ValueError, match="no active sharding context"):
        T_SR.logical_spec(("data",), (8,))


@pytest.mark.parametrize("shape", SHAPES)
def test_batch_and_cache_axes(shape):
    for arch in ARCHS:
        r_cfg, t_cfg = R_R.get_config(arch), T_R.get_config(arch)
        r_shape, t_shape = R_R.INPUT_SHAPES[shape], INPUT_SHAPES[shape]
        assert T_R.batch_logical_axes(t_cfg, t_shape) == \
            R_R.batch_logical_axes(r_cfg, r_shape)
        cache = T_R.abstract_decode_cache(t_cfg, t_shape)
        got = [(p, ax) for p, ax in tree_paths(
            T_S.cache_logical_axes(t_cfg, cache))]
        want = _ref_leaves(R_S.cache_logical_axes(
            r_cfg, R_R.abstract_decode_cache(r_cfg, r_shape)),
            is_leaf=_axes_leaf)
        assert got == want, arch


def _same_artifacts(ra, ta):
    for r_args, t_args in zip(ra.abstract_args, ta.abstract_args,
                              strict=True):
        assert _meta(t_args) == _sds(r_args)
    for r_sh, t_sh in zip(ra.in_shardings, ta.in_shardings, strict=True):
        assert _port_specs(t_sh) == _ref_specs(r_sh)
    assert _port_specs(ta.out_shardings) == _ref_specs(ra.out_shardings)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_build_artifacts_match_reference(arch, mesh):
    r_cfg, t_cfg = R_R.get_config(arch), T_R.get_config(arch)
    r_mesh, t_mesh = _ref_mesh(mesh), _port_mesh(mesh)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        r_shape, t_shape = R_R.INPUT_SHAPES[shape], INPUT_SHAPES[shape]
        if r_shape.mode == "train":
            ra = R_S.build_train_artifacts(r_cfg, r_shape, r_mesh,
                                           r_opt("adam"))
            ta = T_S.build_train_artifacts(t_cfg, t_shape, t_mesh,
                                           t_opt("adam"))
        elif r_shape.mode == "prefill":
            ra = R_S.build_prefill_artifacts(r_cfg, r_shape, r_mesh)
            ta = T_S.build_prefill_artifacts(t_cfg, t_shape, t_mesh)
        else:
            ra = R_S.build_serve_artifacts(r_cfg, r_shape, r_mesh)
            ta = T_S.build_serve_artifacts(t_cfg, t_shape, t_mesh)
        _same_artifacts(ra, ta)
    if mesh == "multi":
        for local_steps in (1, 2):
            ra = R_S.build_dystop_artifacts(
                r_cfg, R_R.INPUT_SHAPES["train_4k"], r_mesh, r_opt("adam"),
                local_steps=local_steps)
            ta = T_S.build_dystop_artifacts(
                t_cfg, INPUT_SHAPES["train_4k"], t_mesh, t_opt("adam"),
                local_steps=local_steps)
            _same_artifacts(ra, ta)


def test_constrain_and_host_mesh():
    x = torch.ones((4, 4))
    assert T_SR.constrain(x, ("data", None)) is x
    host = T_MESH.make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1} and host.n_devices == 1
    assert host.device == torch.device("cpu")
    with T_SR.use_sharding_rules(host):
        assert T_SR.constrain(x, ("data", None)) is x
        # size-1 axes divide every dim: named, and a no-op
        assert T_SR.logical_spec(("data", "embed"), (4, 4)) == \
            T_SR.PartitionSpec("data", None)
    # the production mesh reshards, on one rank's view of it (meta): a
    # replicated batch dim is sliced to the rank's 16 of 256 rows, a dim
    # the target no longer splits is gathered, a partial sum is reduced
    from repro_torch.launch import loopcost as LC
    view = T_MESH.rank_view(T_MESH.make_production_mesh())
    meta = torch.empty((256, 8), device="meta")
    with T_SR.use_sharding_rules(view), \
            LC.CostCounter() as c:
        y = T_SR.constrain(meta, ("data", None), src=T_SR.PartitionSpec())
        assert y.shape == (16, 8) and y.device.type == "meta"
        z = T_SR.constrain(y[:, :1], ("data", None),
                           src=T_SR.PartitionSpec("data", "model"))
        assert z.shape == (16, 16)
        assert T_SR.constrain(y, ("data", None), partial=("model",)
                              ).shape == (16, 8)
    assert dict(c.collective_calls) == {"all-gather": 1, "all-reduce": 1}
    assert dict(c.collectives) == {"all-gather": 16 * 16 * 4,
                                   "all-reduce": 16 * 8 * 4}
    # it raises on a mesh description, which is no rank's place (a family
    # whose step is not sharded is refused where its step is built)
    with T_SR.use_sharding_rules(T_MESH.make_production_mesh()):
        with pytest.raises(ValueError, match="rank_view"):
            T_SR.constrain(x, ("data", None))
    assert T_MESH.make_production_mesh(multi_pod=True).n_devices == 512
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T_MESH.make_host_mesh()


def test_spawn_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    with pytest.raises(RuntimeError, match="spawn: device 'cuda'"):
        T_MESH.spawn(_local_blocks, 2, [])


# --------------------------------------------------------------------------- #
# placements: DTensor's blocks against NamedSharding's, 4 gloo ranks
# --------------------------------------------------------------------------- #

# (mesh sizes, mesh names, tensor shape, spec)
PLACEMENT_CASES = [
    ((2, 2), ("data", "model"), (8, 6), ("data", None)),
    ((2, 2), ("pod", "data"), (8, 3), (("pod", "data"), None)),
    ((2, 2), ("data", "model"), (8, 6), ("data", "model")),
]

_JAX_BLOCKS = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(sys.argv[1])
out = []
for sizes, names, shape, spec in cases:
    devs = np.array(jax.devices()[:4]).reshape(sizes)
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    m = NamedSharding(Mesh(devs, tuple(names)), P(*spec))
    idx = m.devices_indices_map(tuple(shape))
    out.append({d.id: [[s.start or 0, shape[i] if s.stop is None else s.stop]
                       for i, s in enumerate(sl)] for d, sl in idx.items()})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_blocks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _JAX_BLOCKS,
                          json.dumps(PLACEMENT_CASES)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return [{int(k): v for k, v in case.items()}
            for case in json.loads(res.stdout.strip().splitlines()[-1])]


def _local_blocks(cases):
    """On each rank: DTensor's local block of an arange tensor for each
    case, as [start, stop) per dim (read back from its values)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    out = []
    for sizes, names, shape, spec in cases:
        dmesh = init_device_mesh("cpu", tuple(sizes),
                                 mesh_dim_names=tuple(names))
        full = torch.arange(int(np.prod(shape))).reshape(shape)
        spec = T_SR.PartitionSpec(*[tuple(e) if isinstance(e, list) else e
                                    for e in spec])
        local = distribute_tensor(full, dmesh, T_SR.placements(
            spec, names)).to_local()
        coords = [local // int(np.prod(shape[d + 1:])) % shape[d]
                  for d in range(len(shape))]
        out.append([[int(c.min()), int(c.max()) + 1] for c in coords])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


def test_placements_match_named_sharding(jax_blocks):
    ranked = T_MESH.spawn(_local_blocks, 4, PLACEMENT_CASES, device="cpu")
    for c, (case, want) in enumerate(zip(PLACEMENT_CASES, jax_blocks)):
        for rank in range(4):
            assert ranked[rank][c] == want[rank], (case, rank)


def test_placements_refuse_reversed_axes():
    with pytest.raises(ValueError, match="mesh's order"):
        T_SR.placements(T_SR.PartitionSpec(("data", "pod")), ("pod", "data"))

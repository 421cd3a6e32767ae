"""Rank functions of ``tests/test_torch_sharded.py``: they run on gloo ranks started by
``launch.mesh.spawn`` (which imports this module in each rank), so this
module imports no JAX.

``sharded_cases`` runs, for each case, the dense family's sharded grad
step, train step (counted) and prefill on a 2 x 2 (data, model) mesh from
the whole params it is given, and returns every rank's blocks to the
caller, which assembles them with ``assemble``.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeSpec
from repro_torch.dfl import flat_state as T_FS
from repro_torch.launch import loopcost as LC
from repro_torch.launch import mesh as T_MESH
from repro_torch.launch import steps as T_S
from repro_torch.models import registry as T_R
from repro_torch.optim import get_optimizer
from repro_torch.sharding import rules as T_SR
from repro_torch.tree import tree_paths

MESH = (("data", "model"), (2, 2))
LR = 3e-4


def smoke_cfg(arch: str, dtype: str):
    return dataclasses.replace(T_R.get_smoke_config(arch), dtype=dtype)


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def shapes(batch: dict):
    b, s = batch["tokens"].shape
    return ShapeSpec("t", s, b, "train"), ShapeSpec("p", s, b, "prefill")


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def sharded_cases(cases):
    """Each case is (arch, dtype, rule_overrides, param items, numpy
    batch): this rank's blocks of the whole params and the batch, one grad
    step, one Adam train step (lr ``LR``) and one prefill, on the rank
    mesh.  Returns, on rank 0, every rank's [(loss, grad_norm, metrics,
    grads, new params, logits, the train step's count)] per case (numpy,
    f32; the count as ``counted``)."""
    torch.set_num_threads(1)
    mesh = T_MESH.make_rank_mesh(*MESH, "cpu")
    mine = []
    for arch, dtype, over, items, np_batch in cases:
        cfg = smoke_cfg(arch, dtype)
        full = T_FS.params_from_reference(items, "cpu")
        batch = torch_batch(np_batch)
        tshape, pshape = shapes(batch)
        opt = get_optimizer("adam", LR)
        art = T_S.build_train_artifacts(cfg, tshape, mesh, opt,
                                        rule_overrides=over)
        params = T_R.local_params(cfg, full, mesh, art.rules)
        local = T_SR.local_tree(batch, art.in_shardings[2], mesh)
        loss, _, grads, norm = T_S.make_grad_step(
            cfg, mesh=mesh, rules=art.rules)(params, local)
        with LC.CostCounter() as counter:
            new, _, metrics = art.step_fn(params, opt.init(params), local)
        pre = T_S.build_prefill_artifacts(cfg, pshape, mesh,
                                          rule_overrides=over)
        logits = pre.step_fn(params, local)
        mine.append((float(loss), float(norm),
                     {k: float(v) for k, v in metrics.items()},
                     [_numpy(g) for g in grads],
                     [_numpy(t) for _, t in tree_paths(new)],
                     _numpy(logits),
                     counted(counter)))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def assemble(blocks, spec, global_shape) -> np.ndarray:
    """The whole array from each rank's block (rank order) laid out by
    ``spec`` on the 2 x 2 mesh."""
    mesh = T_MESH.Mesh(*MESH)
    out = torch.zeros(global_shape)
    for r, blk in enumerate(blocks):
        T_SR.local_slice(out, spec, T_MESH.rank_view(mesh, r)).copy_(
            torch.from_numpy(blk))
    return out.numpy()


def counted(counter) -> tuple:
    """A cost counter's collective calls and bytes by kind, flops and
    kernel calls."""
    return (dict(counter.collective_calls), dict(counter.collectives),
            counter.dot_flops, dict(counter.kernel_calls))

"""Train, pods-as-workers round, prefill and serve step functions, and the
artifacts that pair each with its abstract inputs and their specs (the
port of ``repro.launch.steps``).

The JAX package's steps are pure functions that ``jax.jit``/pjit lower;
here they are plain callables that run eagerly on the device of the
tensors they are given (the kernels on the card, their plain versions on
the CPU, empty outputs on ``meta``).  ``build_*_artifacts`` return a
``TrainArtifacts``: the step, its arguments as ``meta`` tensors (shapes
and dtypes, nothing allocated) and the ``sharding.rules.PartitionSpec`` of
every input and output leaf on a mesh (``launch.mesh``), from the logical
axes of the model zoo.  The dry-run (``launch/dryrun.py``) runs the step
once on the ``meta`` arguments to count its work; a trainer materialises
them on the card.  On the host mesh of one device every spec is a no-op.

On one rank's place on a mesh of ranks (``launch.mesh.make_rank_mesh``, or
``rank_view`` on ``meta``) the dense family's train and prefill steps run
sharded (explicit SPMD): each rank holds its blocks of every leaf by the
artifacts' own specs (``TrainArtifacts.local_args``; ``registry.
init_params(mesh=)``, ``registry.local_params``) and the model code's
collectives (``sharding.rules``) stand in for GSPMD's.  A leaf's gradient
is summed over every batch axis that does not split it (the batch axes
that do are the FSDP gather's reduce-scatter), ``grad_norm`` counts each
element once, the metrics are replicated, and the prefill's logits are the
rank's block.  Any other family, or adafactor, on a mesh of ranks raises
``NotImplementedError`` (item 9(b) of the roadmap).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry as R
from repro_torch.optim import Optimizer
from repro_torch.sharding import rules as SR
from repro_torch.tree import (tree_from_paths, tree_map, tree_map_with_path,
                              tree_paths)


METRICS = ("ce", "moe_aux", "loss", "grad_norm")


NOT_PORTED = ("sharded execution of the {family} family is not ported "
              "(item 9(b) of the roadmap: the moe, ssm, hybrid, vlm and "
              "enc-dec families); only {families} run on a mesh of ranks")


def _ranked(cfg: ModelConfig, mesh: Optional[Mesh]) -> bool:
    """Whether a step of ``cfg`` runs on one rank's place on a mesh of
    ranks.  Raises ``NotImplementedError`` for a family whose sharded step
    is not ported: the one refusal, met when a train or prefill step is
    built."""
    if mesh is None or not mesh.ranked:
        return False
    if cfg.family not in SR.SHARDED_FAMILIES:
        raise NotImplementedError(NOT_PORTED.format(
            family=cfg.family, families=", ".join(SR.SHARDED_FAMILIES)))
    return True


def _sharded(mesh: Optional[Mesh], rules: Optional[SR.Rules]):
    """The sharding context a step runs under: on a mesh of ranks the
    mesh and rules, else none."""
    if mesh is None or not mesh.ranked:
        return contextlib.nullcontext()
    return SR.use_sharding_rules(mesh, rules)


def _param_leaf_specs(cfg: ModelConfig, mesh: Mesh,
                      rules: Optional[SR.Rules]) -> list:
    params, axes = R.abstract_params(cfg)
    return [sp for _, sp in tree_paths(SR.tree_shardings(
        axes, params, mesh, _rules(rules)))]


def _sum_of_squares(grads, specs, mesh: Optional[Mesh]) -> torch.Tensor:
    """The f32 sum of squares of every gradient element, each counted
    once: on a mesh of ranks a leaf's block counts on the rank at index 0
    of every axis that does not split the leaf, and the sums are psummed
    over the mesh."""
    terms = []
    for i, g in enumerate(grads):
        if specs is not None:
            split = {a for e in specs[i] for a in SR.axis_names(e)}
            if any(mesh.coord(a) != 0 for a in mesh.axis_names
                   if a not in split):
                continue
        terms.append(torch.sum(torch.square(g.to(torch.float32))))
    total = sum(terms) if terms else torch.zeros(
        (), dtype=torch.float32, device=grads[0].device)
    return total if specs is None else SR.reduce_plain(total,
                                                       mesh.axis_names)


def make_grad_step(cfg: ModelConfig, remat: bool = True,
                   mesh: Optional[Mesh] = None,
                   rules: Optional[SR.Rules] = None) -> Callable:
    """``grad_step(params, batch) -> (loss, metrics, grads, grad_norm)``:
    ``compute_loss`` (``metrics``: ``ce``, ``moe_aux``), its gradient as a
    list of leaves in ``tree_paths(params)`` order, and their f32 global
    norm; ``make_train_step``'s first half.  On one rank's place on a mesh
    of ranks each gradient is this rank's block of the whole step's (see
    the module docstring)."""
    ranked = _ranked(cfg, mesh)
    specs = batch_ax = None
    if ranked:
        specs = _param_leaf_specs(cfg, mesh, rules)
        batch_ax = SR.batch_axes(mesh, _rules(rules))

    def grad_step(params, batch):
        leaves = [leaf.detach().requires_grad_()
                  for _, leaf in tree_paths(params)]
        p = tree_from_paths(zip([q for q, _ in tree_paths(params)], leaves))
        with _sharded(mesh, rules):
            with torch.enable_grad():
                loss, metrics = R.compute_loss(cfg, p, batch, remat=remat)
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                if ranked:
                    grads = [SR.reduce_plain(g, tuple(
                        a for a in batch_ax if a not in
                        {n for e in sp for n in SR.axis_names(e)}))
                        for g, sp in zip(grads, specs)]
                norm = torch.sqrt(_sum_of_squares(
                    grads, specs, mesh if ranked else None))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads), norm)

    return grad_step


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    remat: bool = True, mesh: Optional[Mesh] = None,
                    rules: Optional[SR.Rules] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (new_params, new_state,
    metrics)``: one optimizer step on ``compute_loss``'s gradient.
    ``metrics`` holds ``ce``, ``moe_aux``, ``loss`` and ``grad_norm`` (the
    f32 square root of the sum of squares over every gradient leaf), each a
    0-dim tensor on the device.

    ``remat`` (the default, as in the JAX package) recomputes each layer
    group's activations in the backward pass instead of keeping them
    (``transformer.remat_call``): less memory, the kernels of the group
    launched twice, and the same loss and gradients to the bit.

    With one rank's place on a mesh of ranks (``mesh``, and the
    logical-axis ``rules``, the defaults unless given) the step takes and
    returns this rank's blocks of params, state and batch, sharded as the
    module docstring says; its metrics are the whole step's."""
    grad_step = make_grad_step(cfg, remat, mesh, rules)

    def train_step(params, opt_state, batch):
        loss, metrics, grads, norm = grad_step(params, batch)
        paths = [path for path, _ in tree_paths(params)]
        with _sharded(mesh, rules), torch.no_grad():
            new_params, new_state = optimizer.update(
                tree_from_paths(zip(paths, grads)), opt_state,
                tree_map(torch.Tensor.detach, params))
        metrics["loss"] = loss
        metrics["grad_norm"] = norm
        return new_params, new_state, metrics

    return train_step


def _put_pod(stacked, i: int, pod) -> None:
    """Copy the one-pod tree ``pod`` into slot ``i`` of ``stacked``."""
    for (_, d), (_, x) in zip(tree_paths(stacked), tree_paths(pod)):
        d[i].copy_(x)


def init_pod_states(optimizer: Optimizer, params):
    """Each pod's ``optimizer.init`` state stacked on a leading pod axis
    (the JAX package's ``jax.vmap(optimizer.init)`` over stacked params)."""
    block = tree_paths(params)[0][1].shape[0]
    states = [optimizer.init(tree_map(lambda t: t[i], params))
              for i in range(block)]
    return tree_map(lambda *leaves: torch.stack(leaves), *states)


def make_dystop_round_step(cfg: ModelConfig, optimizer: Optimizer,
                           mesh=None, remat: bool = True,
                           local_steps: int = 1) -> Callable:
    """One DySTop round on the pods-as-workers plane (paper Alg. 1 with
    whole model replicas as workers): ``round_step(params, opt_state,
    batch, mix_w) -> (params, opt_state, metrics)``.

    ``params`` and ``opt_state`` leaves carry a leading pod axis: every pod
    without a ``mesh``, else this rank's block of the pods
    (``launch.mesh.FleetMesh``, ``core.protocol.pod_sharding``).  ``batch``
    leaves are (pods, local_steps, B / n_pods, ...), the JAX package's
    layout, the block's pods only on a rank.  Each pod takes
    ``local_steps`` train steps (``make_train_step``) on its own batches,
    with no gradient sync across pods (a loop over the block: the kernels
    do not vmap); its metrics are its last step's.  Then
    ``core.protocol.dystop_pod_mix`` mixes the replicas with ``mix_w``
    (n_pods x n_pods, from the host coordinator; the optimizer state is not
    mixed), and each metric is averaged over all n_pods pods (on ranks, a
    zero-padded (n_pods, 4) ``FleetSharding.psum`` first, so every form
    sums the same values in the same order).  Returns new trees; the
    inputs are left as they are."""
    from repro_torch.core.protocol import dystop_pod_mix, pod_sharding

    base_step = make_train_step(cfg, optimizer, remat=remat)

    def round_step(params, opt_state, batch, mix_w):
        first = tree_paths(batch)[0][1]
        block = first.shape[0]
        if first.shape[1] != local_steps:
            raise ValueError(f"round step: batch has {first.shape[1]} local "
                             f"steps, expected {local_steps}")
        n_pods = block * (1 if mesh is None else mesh.n_shards)
        shd = pod_sharding(mesh, n_pods)
        # each trained pod is copied into its slot as it ends (stacking
        # all of them after the loop made the rank form's round slower on
        # a card shared by 4 ranks: PERF.md, the pods cell)
        new_params = tree_map(torch.empty_like, params)
        new_state = tree_map(torch.empty_like, opt_state)
        rows = []
        for i in range(block):
            p = tree_map(lambda t: t[i], params)
            s = tree_map(lambda t: t[i], opt_state)
            for t in range(local_steps):
                p, s, m = base_step(p, s,
                                    tree_map(lambda x: x[i, t], batch))
            _put_pod(new_params, i, p)
            _put_pod(new_state, i, s)
            rows.append(torch.stack([m[k].to(torch.float32)
                                     for k in METRICS]))
            del p, s
        new_params = dystop_pod_mix(new_params, mix_w, mesh)
        every = torch.stack(rows)
        if shd is not None:
            every = shd.psum(torch.zeros(
                (n_pods, len(METRICS)), dtype=torch.float32,
                device=every.device).index_copy_(
                0, torch.arange(*shd.home, device=every.device), every))
        mean = every.sum(0) / n_pods
        return new_params, new_state, dict(zip(METRICS, mean.unbind()))

    return round_step


def make_prefill_step(cfg: ModelConfig, mesh: Optional[Mesh] = None,
                      rules: Optional[SR.Rules] = None) -> Callable:
    """``prefill_step(params, batch) -> logits`` (``forward_logits``); on
    one rank's place on a mesh of ranks (``make_train_step``) the rank's
    blocks in and its block of the logits out."""
    _ranked(cfg, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        with _sharded(mesh, rules):
            return R.forward_logits(cfg, params, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, cache, token) -> (logits, cache)``: one decode
    step, the cache updated in place (``registry.serve_step``)."""
    @torch.no_grad()
    def serve_step(params, cache, token):
        return R.serve_step(cfg, params, cache, token)

    return serve_step


# --------------------------------------------------------------------------- #
# sharding construction
# --------------------------------------------------------------------------- #


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _rules(overrides: Optional[dict]) -> SR.Rules:
    return {**SR.DEFAULT_RULES, **(overrides or {})}


def shardings_from_axes(axes_tree, shapes_tree, mesh: Mesh,
                        rules: Optional[SR.Rules] = None):
    """The spec of every leaf of ``shapes_tree`` (tensors; ``meta`` ones
    will do) from the matching logical axes."""
    return SR.tree_shardings(axes_tree, shapes_tree, mesh, rules)


def cache_logical_axes(cfg: ModelConfig, cache_shapes) -> Any:
    """Logical axes of every decode-cache leaf, by its key and ndim (the
    leading axes beyond a leaf's own are the ``"stack"`` of scanned
    groups)."""
    def one(path, leaf):
        name = next((p for p in reversed(path) if isinstance(p, str)), None)
        nd = leaf.dim()
        if name == "pos":
            return ()
        if name in ("k", "v"):          # (stack*, B, W, K, hd)
            return ("stack",) * (nd - 4) + ("data", "seq_act", "kv_heads",
                                            None)
        if name == "k_pos":             # (stack*, B, W)
            return ("stack",) * (nd - 2) + ("data", "seq_act")
        if name == "state":             # (stack*, B, H, P, N)
            return ("stack",) * (nd - 4) + ("data", "ssm_inner", None, None)
        if name == "conv_tail":         # (stack*, B, W-1, C)
            return ("stack",) * (nd - 3) + ("data", None, "ssm_inner")
        if name == "h":                 # (stack*, B, dr)
            return ("stack",) * (nd - 2) + ("data", "rnn_width")
        return (None,) * nd

    return tree_map_with_path(one, cache_shapes)


@dataclasses.dataclass
class TrainArtifacts:
    """A step function with its arguments as ``meta`` tensors, the specs
    of its inputs and outputs (trees of ``PartitionSpec``) and the
    logical-axis rules those specs were made with; on one rank's place on
    a mesh of ranks also this rank's arguments (``local_args``: its blocks
    of ``abstract_args`` by ``in_shardings``, on ``meta``), which the step
    then takes."""
    step_fn: Any
    abstract_args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    rules: SR.Rules
    local_args: Optional[Tuple[Any, ...]] = None


def _local_args(args, specs, mesh: Mesh) -> Tuple[Any, ...]:
    """This rank's blocks of the ``meta`` arguments."""
    return tuple(SR.local_tree(a, s, mesh) for a, s in zip(args, specs))


def _check_batch_split(batch_sh, mesh: Mesh, rules: SR.Rules) -> None:
    """Raise unless every batch input splits over all the batch axes: a
    replicated batch would count each row once per replica in the loss."""
    want = set(SR.batch_axes(mesh, rules))
    for name, spec in batch_sh.items():
        if not want <= set(SR.axis_names(spec[0])):
            raise ValueError(f"{name}: the global batch does not split over "
                             f"the batch axes {sorted(want)} (spec {spec})")


def _metrics_specs():
    return {k: SR.PartitionSpec() for k in METRICS}


def build_train_artifacts(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
                          optimizer: Optimizer, remat: bool = True,
                          rule_overrides: Optional[dict] = None
                          ) -> TrainArtifacts:
    """``make_train_step`` with (params, opt_state, batch) on ``meta`` and
    their specs; the outputs keep the inputs' specs, metrics replicated."""
    rules = _rules(rule_overrides)
    params, param_axes = R.abstract_params(cfg)
    opt_state = optimizer.init(params)
    batch = R.batch_specs(cfg, shape)
    params_sh = shardings_from_axes(param_axes, params, mesh, rules)
    opt_sh = shardings_from_axes(optimizer.state_axes(param_axes), opt_state,
                                 mesh, rules)
    batch_sh = shardings_from_axes(R.batch_logical_axes(cfg, shape), batch,
                                   mesh, rules)
    args, in_sh = (params, opt_state, batch), (params_sh, opt_sh, batch_sh)
    local = None
    if mesh.ranked:
        _check_batch_split(batch_sh, mesh, rules)
        local = _local_args(args, in_sh, mesh)
    return TrainArtifacts(
        step_fn=make_train_step(cfg, optimizer, remat=remat, mesh=mesh,
                                rules=rules),
        abstract_args=args, in_shardings=in_sh,
        out_shardings=(params_sh, opt_sh, _metrics_specs()),
        rules=rules, local_args=local)


def build_dystop_artifacts(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
                           optimizer: Optimizer, remat: bool = True,
                           local_steps: int = 1,
                           rule_overrides: Optional[dict] = None
                           ) -> TrainArtifacts:
    """The pods-as-workers round step (``make_dystop_round_step``, every
    pod in this process): each params and optimizer-state leaf with a
    leading pod axis over ``"pod"`` and the per-pod fsdp/tensor layout
    behind it; the global batch split over the pods as (pods, local_steps,
    B / pods, ...); the (pods, pods) mixing matrix replicated.  ``"data"``
    maps to the data axis alone inside a pod (``"pod"`` is the replica
    axis), over any other ``rule_overrides``."""
    n_pods = mesh.shape["pod"]
    rules = _rules({**(rule_overrides or {}), "data": ("data",)})
    params, param_axes = R.abstract_params(cfg)
    opt_state = optimizer.init(params)
    opt_axes = optimizer.state_axes(param_axes)
    batch = R.batch_specs(cfg, shape)
    batch_axes = R.batch_logical_axes(cfg, shape)

    def stack(t):
        return _meta((n_pods,) + tuple(t.shape), t.dtype)

    def stack_batch(t):
        if t.shape[0] % n_pods:
            raise ValueError(f"build_dystop_artifacts: global batch "
                             f"{t.shape[0]} does not split over {n_pods} "
                             f"pods")
        return _meta((n_pods, local_steps, t.shape[0] // n_pods)
                     + tuple(t.shape[1:]), t.dtype)

    def shard(ax_tree, tree, skip):
        return tree_map(lambda ax, t: SR.PartitionSpec(
            "pod", *([None] * (skip - 1)),
            *SR.logical_spec(ax, t.shape[skip:], mesh, rules)), ax_tree, tree)

    sp, so = tree_map(stack, params), tree_map(stack, opt_state)
    sb = tree_map(stack_batch, batch)
    params_sh, opt_sh = shard(param_axes, sp, 1), shard(opt_axes, so, 1)
    return TrainArtifacts(
        step_fn=make_dystop_round_step(cfg, optimizer, remat=remat,
                                       local_steps=local_steps),
        abstract_args=(sp, so, sb, _meta((n_pods, n_pods), torch.float32)),
        in_shardings=(params_sh, opt_sh, shard(batch_axes, sb, 2),
                      SR.PartitionSpec()),
        out_shardings=(params_sh, opt_sh, _metrics_specs()),
        rules=rules)


def build_prefill_artifacts(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
                            rule_overrides: Optional[dict] = None
                            ) -> TrainArtifacts:
    """``make_prefill_step`` with (params, batch) on ``meta``; the logits
    (B, S, V) split over the batch and the model axis."""
    rules = _rules(rule_overrides)
    params, param_axes = R.abstract_params(cfg)
    batch = R.batch_specs(cfg, shape)
    logits_sh = SR.logical_spec(("data", None, "vocab_act"),
                                (shape.global_batch, shape.seq_len, 1 << 30),
                                mesh, rules)
    args = (params, batch)
    in_sh = (shardings_from_axes(param_axes, params, mesh, rules),
             shardings_from_axes(R.batch_logical_axes(cfg, shape), batch,
                                 mesh, rules))
    local = None
    if mesh.ranked:
        _check_batch_split(in_sh[1], mesh, rules)
        local = _local_args(args, in_sh, mesh)
    return TrainArtifacts(
        step_fn=make_prefill_step(cfg, mesh=mesh, rules=rules),
        abstract_args=args, in_shardings=in_sh, out_shardings=logits_sh,
        rules=rules, local_args=local)


def build_serve_artifacts(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
                          rule_overrides: Optional[dict] = None
                          ) -> TrainArtifacts:
    """``make_serve_step`` with (params, decode cache, token) on
    ``meta``; the outputs are the logits (B, 1, V) and the cache."""
    rules = _rules(rule_overrides)
    params, param_axes = R.abstract_params(cfg)
    cache = R.abstract_decode_cache(cfg, shape)
    token = _meta((shape.global_batch, 1), torch.int32)
    cache_sh = shardings_from_axes(cache_logical_axes(cfg, cache), cache,
                                   mesh, rules)
    logits_sh = SR.logical_spec(("data", None, "vocab_act"),
                                (shape.global_batch, 1, 1 << 30), mesh, rules)
    return TrainArtifacts(
        step_fn=make_serve_step(cfg),
        abstract_args=(params, cache, token),
        in_shardings=(shardings_from_axes(param_axes, params, mesh, rules),
                      cache_sh,
                      SR.logical_spec(("data", None), token.shape, mesh,
                                      rules)),
        out_shardings=(logits_sh, cache_sh),
        rules=rules)

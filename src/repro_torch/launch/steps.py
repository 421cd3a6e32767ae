"""Train, pods-as-workers round, prefill and serve step functions (the
port of ``repro.launch.steps``'s ``make_train_step``,
``make_dystop_round_step``, ``make_prefill_step`` and ``make_serve_step``).

The JAX package's steps are pure functions that ``jax.jit``/pjit lower;
here they are plain callables that run eagerly on the device of the
tensors they are given (the kernels on the card, their plain versions on
the CPU).  The sharding constructors beside them in the JAX package
(``build_*_artifacts``, ``shardings_from_axes``, ``cache_logical_axes``)
build logical-axis shardings, which the port does not carry yet (the
sharding item of the roadmap).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as R
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_from_paths, tree_map, tree_paths


METRICS = ("ce", "moe_aux", "loss", "grad_norm")


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    remat: bool = True) -> Callable:
    """``train_step(params, opt_state, batch) -> (new_params, new_state,
    metrics)``: one optimizer step on ``compute_loss``'s gradient.
    ``metrics`` holds ``ce``, ``moe_aux``, ``loss`` and ``grad_norm`` (the
    f32 square root of the sum of squares over every gradient leaf), each a
    0-dim tensor on the device.

    ``remat`` (the default, as in the JAX package) recomputes each layer
    group's activations in the backward pass instead of keeping them
    (``transformer.remat_call``): less memory, the kernels of the group
    launched twice, and the same loss and gradients to the bit."""
    def train_step(params, opt_state, batch):
        paths = [path for path, _ in tree_paths(params)]
        p = tree_map(lambda leaf: leaf.detach().requires_grad_(), params)
        leaves = [leaf for _, leaf in tree_paths(p)]
        with torch.enable_grad():
            loss, metrics = R.compute_loss(cfg, p, batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new_params, new_state = optimizer.update(
                tree_from_paths(zip(paths, grads)), opt_state,
                tree_map(torch.Tensor.detach, p))
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss.detach()
            metrics["grad_norm"] = torch.sqrt(sum(
                torch.sum(torch.square(g.to(torch.float32))) for g in grads))
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


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill_step(params, batch) -> logits`` (``forward_logits``)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return R.forward_logits(cfg, params, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, cache, token) -> (logits, cache)``: one decode
    step, the cache updated in place (``registry.serve_step``)."""
    @torch.no_grad()
    def serve_step(params, cache, token):
        return R.serve_step(cfg, params, cache, token)

    return serve_step

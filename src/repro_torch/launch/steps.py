"""Train, prefill and serve step functions (the port of
``repro.launch.steps``'s ``make_train_step``, ``make_prefill_step`` and
``make_serve_step``).

The JAX package's steps are pure functions that ``jax.jit``/pjit lower;
here they are plain callables that run eagerly on the device of the
tensors they are given (the kernels on the card, their plain versions on
the CPU).  The sharding constructors beside them in the JAX package
(``build_*_artifacts``, ``shardings_from_axes``, ``cache_logical_axes``)
and the pods-as-workers round step (``make_dystop_round_step``) are XLA
constructs with no counterpart here yet: ROADMAP Queue A item 8(b).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as R
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_from_paths, tree_map, tree_paths


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    remat: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (new_params, new_state,
    metrics)``: one optimizer step on ``compute_loss``'s gradient.
    ``metrics`` holds ``ce``, ``moe_aux``, ``loss`` and ``grad_norm`` (the
    f32 square root of the sum of squares over every gradient leaf), each a
    0-dim tensor on the device.

    ``remat=True`` (the JAX package's default: recompute activations in the
    backward pass) is not in the port's model plane and raises
    ``NotImplementedError``; it changes memory, not values, and the trainer
    runs without it, as the JAX package's does."""
    if remat:
        raise NotImplementedError(
            "make_train_step(remat=True): activation recomputation is not "
            "ported to PyTorch yet — ROADMAP Queue A item 8(b); pass "
            "remat=False (the same values)")

    def train_step(params, opt_state, batch):
        paths = [path for path, _ in tree_paths(params)]
        p = tree_map(lambda leaf: leaf.detach().requires_grad_(), params)
        leaves = [leaf for _, leaf in tree_paths(p)]
        with torch.enable_grad():
            loss, metrics = R.compute_loss(cfg, p, batch)
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

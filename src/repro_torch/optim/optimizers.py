"""Optimizers over nested parameter trees, elementwise, in PyTorch.

The port of ``repro.optim.optimizers``: an ``Optimizer`` is a triple of
functions; its state mirrors the param tree plus a scalar int32 step.  Each
update computes in f32 and rounds the new parameter to the leaf's dtype
(bf16 on the LM plane) before returning it — the LM fleet writes that
rounded value back into its f32 row, as the JAX package does; skipping the
rounding lets the port drift from the reference within a few rounds.
``state_axes`` maps the params' logical-axes tree to the state's
(``launch/steps.py`` builds the state's specs from it).

Flat-fleet residency contract: the state is a tree of tensors whose
structure the param structure alone fixes, and whose leaves survive an f32
round-trip (the step counter exactly, below 2^24), so the LM plane keeps N
workers' states as one flat ``(N, S)`` buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]   # (grads, state, params)
    state_axes: Callable[[Any], Any]                      # param axes -> state's


def _zeros_like_tree(params, dtype=None):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype or p.dtype,
                                          device=p.device), params)


def _step0(params):
    device = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def _part(out, i):
    return tree_map(lambda t: t[i], out)


def _mu_axes(param_axes):
    return {"step": (), "mu": param_axes}


def sgd(lr: float = 1e-2, momentum: float = 0.9,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": _step0(params), "mu": _zeros_like_tree(params, F32)}

    def update(grads, state, params):
        def upd(g, mu, p):
            g = g.to(F32)
            if weight_decay:
                g = g + weight_decay * p.to(F32)
            mu_new = momentum * mu + g
            return (p.to(F32) - lr * mu_new).to(p.dtype), mu_new

        out = tree_map(upd, grads, state["mu"], params)
        return _part(out, 0), {"step": state["step"] + 1, "mu": _part(out, 1)}

    return Optimizer("sgd", init, update, _mu_axes)


def sgdm_bf16(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    """Memory-lean variant (bf16 momentum)."""
    def init(params):
        return {"step": _step0(params),
                "mu": _zeros_like_tree(params, torch.bfloat16)}

    def update(grads, state, params):
        def upd(g, mu, p):
            mu_new = momentum * mu.to(F32) + g.to(F32)
            return ((p.to(F32) - lr * mu_new).to(p.dtype),
                    mu_new.to(torch.bfloat16))

        out = tree_map(upd, grads, state["mu"], params)
        return _part(out, 0), {"step": state["step"] + 1, "mu": _part(out, 1)}

    return Optimizer("sgdm_bf16", init, update, _mu_axes)


def adam(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": _step0(params),
                "mu": _zeros_like_tree(params, F32),
                "nu": _zeros_like_tree(params, F32)}

    def update(grads, state, params):
        step = state["step"] + 1
        c1 = 1.0 - b1 ** step.to(F32)
        c2 = 1.0 - b2 ** step.to(F32)

        def upd(g, mu, nu, p):
            # the same ops in the same order, with the temporaries freed or
            # reused as they go: at a 655M-parameter leaf each f32 copy is
            # 2.6 GB, and the fleet leaves little room beside them
            g = g.to(F32)
            mu_new = b1 * mu + (1 - b1) * g
            nu_new = b2 * nu + (1 - b2) * torch.square(g)
            del g
            u = (mu_new / c1).div_(torch.sqrt(nu_new / c2).add_(eps))
            if weight_decay:
                u = u + weight_decay * p.to(F32)
            return torch.sub(p, u.mul_(lr)).to(p.dtype), mu_new, nu_new

        out = tree_map(upd, grads, state["mu"], state["nu"], params)
        return _part(out, 0), {"step": step, "mu": _part(out, 1),
                               "nu": _part(out, 2)}

    def state_axes(param_axes):
        return {"step": (), "mu": param_axes, "nu": param_axes}

    return Optimizer("adam", init, update, state_axes)


def adafactor(lr: float = 3e-4, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moment (Shazeer & Stern 2018): matrices keep row and
    column statistics instead of a full f32 moment; vectors keep a full
    one."""

    def init(params):
        def one(p):
            if p.dim() >= 2:
                return {"row": torch.zeros(p.shape[:-1], dtype=F32,
                                           device=p.device),
                        "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                           dtype=F32, device=p.device)}
            return {"full": torch.zeros(p.shape, dtype=F32, device=p.device)}

        return {"step": _step0(params), "mu": tree_map(one, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        beta = 1.0 - step.to(F32) ** -decay

        def upd(g, m, p):
            g = g.to(F32)
            g2 = torch.square(g) + eps
            if "row" in m:
                row = beta * m["row"] + (1 - beta) * g2.mean(-1)
                col = beta * m["col"] + (1 - beta) * g2.mean(-2)
                row_mean = row.mean(-1, keepdim=True)
                v = ((row / torch.clamp(row_mean, min=eps))[..., None]
                     * col[..., None, :])
                new_m = {"row": row, "col": col}
            else:
                v = beta * m["full"] + (1 - beta) * g2
                new_m = {"full": v}
            u = g * torch.rsqrt(torch.clamp(v, min=eps))
            rms = torch.sqrt(torch.square(u).mean() + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (p.to(F32) - lr * u).to(p.dtype), new_m

        out = tree_map(upd, grads, state["mu"], params)
        return _part(out, 0), {"step": step, "mu": _part(out, 1)}

    def state_axes(param_axes):
        """A factored leaf's row statistics drop its last axis, its column
        statistics the one before."""
        def one(ax):
            if len(ax) >= 2:
                return {"row": ax[:-1], "col": ax[:-2] + ax[-1:]}
            return {"full": ax}

        return {"step": (), "mu": tree_map(one, param_axes)}

    return Optimizer("adafactor", init, update, state_axes)


OPTIMIZER_NAMES = ("adam", "sgd", "sgdm_bf16", "adafactor")


def get_optimizer(name: str, lr: float = 3e-4) -> Optimizer:
    if name == "adam":
        return adam(lr)
    if name == "sgd":
        return sgd(lr)
    if name == "sgdm_bf16":
        return sgdm_bf16(lr)
    if name == "adafactor":
        return adafactor(lr)
    raise ValueError(f"unknown optimizer {name}; one of {OPTIMIZER_NAMES}")

"""Flat (N, P) model-buffer representation for the fused round engine.

All N worker replicas live in ONE ``(N, P)`` f32 tensor: Eq. 4 mixing is one
skinny product over the buffer (``kernels.aggregate``) and local SGD works on
gathered rows (``kernels.fused_sgd``).  A stacked model is a dict of tensors
with a leading worker axis; the buffer concatenates the leaves' trailing dims
in sorted-key order — the order ``jax.tree.leaves`` gives a dict, so a buffer
of the JAX package and a buffer of this port compare column for column (the
sim-plane MLP's columns are ``b1, b2, b3, w1, w2, w3``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Ravel/unravel metadata of a stacked dict of tensors (leaves (N, ...))."""
    keys: Tuple[str, ...]                      # leaf names, sorted
    shapes: Tuple[Tuple[int, ...], ...]        # per-leaf trailing shapes
    dtypes: Tuple[torch.dtype, ...]            # per-leaf dtypes
    offsets: Tuple[int, ...]                   # per-leaf start column
    sizes: Tuple[int, ...]                     # per-leaf column count
    n_params: int                              # P = sum(sizes)


def spec_of(stacked: Params) -> FlatSpec:
    """The FlatSpec of a stacked dict (leaves (N, ...))."""
    keys = tuple(sorted(stacked))
    shapes = tuple(tuple(stacked[k].shape[1:]) for k in keys)
    dtypes = tuple(stacked[k].dtype for k in keys)
    sizes = tuple(int(np.prod(s, dtype=np.int64)) if s else 1 for s in shapes)
    offsets = tuple(int(o) for o in np.cumsum((0,) + sizes)[:-1])
    return FlatSpec(keys=keys, shapes=shapes, dtypes=dtypes, offsets=offsets,
                    sizes=sizes, n_params=int(sum(sizes)))


def flatten_stacked(stacked: Params) -> Tuple[torch.Tensor, FlatSpec]:
    """Stacked dict (leaves (N, ...)) -> ((N, P) f32 buffer, FlatSpec)."""
    spec = spec_of(stacked)
    buf = torch.cat([stacked[k].reshape(stacked[k].shape[0], -1)
                     .to(torch.float32) for k in spec.keys], dim=1)
    return buf, spec


def from_reference(stacked_np: Dict[str, np.ndarray], device
                   ) -> Tuple[torch.Tensor, FlatSpec]:
    """The JAX package's stacked parameters (as numpy arrays) -> this port's
    flat buffer on ``device``, bit for bit (same column order)."""
    buf, spec = flatten_stacked({k: torch.tensor(np.asarray(v))
                                 for k, v in stacked_np.items()})
    return buf.to(device), spec


def unflatten(buf: torch.Tensor, spec: FlatSpec) -> Params:
    """(N, P) buffer -> stacked dict with the original shapes/dtypes (views
    where the dtype is already f32)."""
    n = buf.shape[0]
    return {k: buf[:, o:o + s].reshape((n,) + shape).to(dtype)
            for k, o, s, shape, dtype in zip(spec.keys, spec.offsets,
                                             spec.sizes, spec.shapes,
                                             spec.dtypes)}


def unravel_row(vec: torch.Tensor, spec: FlatSpec) -> Params:
    """One worker's (P,) parameter vector -> its single-model dict."""
    return {k: vec[o:o + s].reshape(shape).to(dtype)
            for k, o, s, shape, dtype in zip(spec.keys, spec.offsets,
                                             spec.sizes, spec.shapes,
                                             spec.dtypes)}


def weighted_row(buf: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The alpha-weighted (P,) parameter vector: the data-size-weighted
    global model of paper Eq. 11 is one ``(N,) @ (N, P)`` product."""
    return alpha.to(torch.float32) @ buf


def ravel_row(tree: Params, spec: FlatSpec) -> torch.Tensor:
    """Single-model dict -> (P,) f32 vector (inverse of ``unravel_row``)."""
    return torch.cat([tree[k].reshape(-1).to(torch.float32)
                      for k in spec.keys])

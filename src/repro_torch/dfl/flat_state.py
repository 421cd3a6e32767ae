"""Flat (N, P) model-buffer representation for the fused round engine.

All N worker replicas live in ONE ``(N, P)`` f32 tensor: Eq. 4 mixing is one
skinny product over the buffer (``kernels.aggregate``) and local SGD works on
gathered rows (``kernels.fused_sgd``).  A stacked model is a dict of tensors
with a leading worker axis; the buffer concatenates the leaves' trailing dims
in sorted-key order — the order ``jax.tree.leaves`` gives a dict, so a buffer
of the JAX package and a buffer of this port compare column for column (the
sim-plane MLP's columns are ``b1, b2, b3, w1, w2, w3``).

Nested trees (the LM plane's params and optimizer state, ``repro_torch.tree``)
flatten through the same ``FlatSpec`` with leaf paths as keys: sorted paths
are the jax leaf order.  An LM fleet is resident as two buffers, params
``(N, P)`` and optimizer state ``(N, S)`` (``FleetSpec``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_from_paths, tree_map, tree_paths

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Ravel/unravel metadata of a stacked dict of tensors (leaves (N, ...))."""
    keys: tuple                                # leaf names (or tree paths),
                                               #   sorted
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


def tensor_from_reference(leaf) -> torch.Tensor:
    """A numpy leaf of the JAX package as a tensor of the same dtype, bit
    for bit: bf16 (``ml_dtypes``) goes through f32, which holds it
    exactly."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_reference(items: Iterable[Tuple[tuple, np.ndarray]], device
                          ) -> Any:
    """One model's params from the JAX package's ``(path, numpy leaf)``
    pairs (paths as tuples of dict keys and list indices) -> this port's
    nested tree on ``device``, bit for bit, dtypes included."""
    return tree_from_paths((path, tensor_from_reference(leaf).to(device))
                           for path, leaf in items)


def cache_from_reference(cache, device) -> Any:
    """The JAX package's decode cache with numpy leaves (``pos``; per layer
    KV rows and ``k_pos``, or SSM ``state`` and ``conv_tail``; ``blocks``
    stacked on the group axis) -> this port's cache on ``device``, bit for
    bit: the two packages share the layout, so a stream can be handed over
    in its middle."""
    return tree_map(lambda leaf: tensor_from_reference(leaf).to(device), cache)


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


def nbytes_of(spec: FlatSpec) -> int:
    """Bytes of ONE row's tree at its original dtypes (Eq. 10 pricing): the
    buffer stores f32, but a bf16 leaf ships at 2 bytes.  The LM planner's
    ``exp_link_time`` reads this, so it shapes the control plane."""
    return sum(s * d.itemsize for s, d in zip(spec.sizes, spec.dtypes))


# --------------------------------------------------------------------------- #
# nested trees and LM fleets: params + optimizer state resident together
# --------------------------------------------------------------------------- #


def tree_spec(tree) -> FlatSpec:
    """The FlatSpec of ONE replica's nested tree (no worker axis); its keys
    are the leaf paths."""
    return spec_of({path: leaf[None] for path, leaf in tree_paths(tree)})


def unravel_tree(vec: torch.Tensor, spec: FlatSpec, copy: bool = False):
    """One (P,) row -> its nested tree at the recorded dtypes.  ``copy``
    makes every leaf a fresh tensor (f32 leaves are views otherwise)."""
    return tree_from_paths(
        (k, vec[o:o + s].reshape(shape).to(dtype, copy=copy))
        for k, o, s, shape, dtype in zip(spec.keys, spec.offsets, spec.sizes,
                                         spec.shapes, spec.dtypes))


def ravel_tree_into(tree, spec: FlatSpec, out: torch.Tensor) -> torch.Tensor:
    """Write a nested tree into the (P,) row ``out`` in place (f32, leaf
    dtypes widened exactly)."""
    leaves = dict(tree_paths(tree))
    for k, o, s in zip(spec.keys, spec.offsets, spec.sizes):
        out[o:o + s].copy_(leaves[k].reshape(-1))
    return out


def unflatten_tree(buf: torch.Tensor, spec: FlatSpec):
    """(N, P) buffer -> stacked nested tree (leaves (N, ...))."""
    return tree_from_paths(unflatten(buf, spec).items())


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Ravel metadata of a fleet resident as TWO flat buffers: params
    ``(N, P)`` and optimizer state ``(N, S)``.  The opt tree's columns run
    ``mu``, ``nu``, ``step`` (sorted keys); the int32 step counter is stored
    as f32, exact below 2^24."""
    params: FlatSpec
    opt: FlatSpec


def flatten_fleet(stacked_params, stacked_opt
                  ) -> Tuple[torch.Tensor, torch.Tensor, FleetSpec]:
    """Stacked (params, opt) trees (leaves (N, ...)) -> ((N, P), (N, S) f32
    buffers, FleetSpec)."""
    pbuf, pspec = flatten_stacked(dict(tree_paths(stacked_params)))
    obuf, ospec = flatten_stacked(dict(tree_paths(stacked_opt)))
    return pbuf, obuf, FleetSpec(params=pspec, opt=ospec)


def fleet_from_reference(pbuf: np.ndarray, obuf: np.ndarray, spec: FleetSpec,
                         device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's resident fleet buffers (``LMFleet.pbuf``/``obuf`` as
    numpy f32) -> this port's buffers on ``device``, bit for bit: both
    packages lay the columns out in jax leaf order."""
    out = []
    for name, arr, fs in (("pbuf", pbuf, spec.params),
                          ("obuf", obuf, spec.opt)):
        arr = np.asarray(arr)
        if arr.dtype != np.float32 or arr.ndim != 2 \
                or arr.shape[1] != fs.n_params:
            raise ValueError(
                f"fleet_from_reference: {name} is {arr.dtype} "
                f"{arr.shape}; this fleet needs f32 (N, {fs.n_params})")
        out.append(torch.from_numpy(arr.copy()).to(device))
    if out[0].shape[0] != out[1].shape[0]:
        raise ValueError(f"fleet_from_reference: pbuf has {out[0].shape[0]} "
                         f"rows, obuf {out[1].shape[0]}")
    return out[0], out[1]

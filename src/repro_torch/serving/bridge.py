"""Checkpoint -> serving bridge: put a trained fleet in front of traffic
(the port of ``repro.serving.bridge``).

``run_lm_federation`` (this port's or the JAX package's: one layout,
``checkpoint.io``) snapshots the whole resident fleet as flat ``(N, P)`` f32
buffers (``params|pbuf`` / ``params|obuf`` in an npz with a ``__meta__``
json).  This module reads those snapshots through ``checkpoint.io`` and
turns the buffer back into serving params for :class:`ServeEngine`:

* the **Eq. 11 global model** — ``alpha @ pbuf`` via
  ``flat_state.weighted_row`` (uniform alpha by default), or
* **any single worker row** — ``pbuf[worker]``, bit for bit (the f32
  buffer holds bf16 and int32 leaves exactly),

then ``flat_state.unravel_tree`` casts every leaf back to the model's dtype.
The FlatSpec comes from the arch's ``init_params`` on the ``meta`` device
(no parameter allocation) and is checked against the snapshot: the stored
``arch`` id (if recorded) and the flat width P must both match.
"""
from __future__ import annotations

import pathlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import io as CIO
from repro_torch.configs.base import ModelConfig
from repro_torch.dfl import flat_state as FS
from repro_torch.models import registry as R
from repro_torch.device import resolve_device
from repro_torch.serving.engine import ServeEngine

Params = Dict[str, Any]


def fleet_spec_for(cfg: ModelConfig) -> FS.FlatSpec:
    """FlatSpec of one replica of ``cfg`` in jax leaf order, built on the
    ``meta`` device (no weight allocation)."""
    return FS.tree_spec(R.init_params(cfg, None))


def _read_fleet(path: str | pathlib.Path, keys: Tuple[str, ...]
                ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    blobs, extra = CIO.read_checkpoint(path, keys)
    if "params|pbuf" not in blobs:
        raise KeyError(f"{path}: not a fleet checkpoint "
                       f"(missing params|pbuf)")
    return blobs, extra


def load_fleet_checkpoint(path: str | pathlib.Path
                          ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """Read a fleet snapshot -> (pbuf (N, P), obuf (N, S), extra metadata)."""
    blobs, extra = _read_fleet(path, ("params|pbuf", "params|obuf"))
    return blobs["params|pbuf"], blobs["params|obuf"], extra


def serving_params_from_checkpoint(
        path: str | pathlib.Path, cfg: ModelConfig,
        worker: Optional[int] = None, alpha: Optional[np.ndarray] = None,
        device="cuda") -> Params:
    """Serving params on ``device`` from a fleet checkpoint.

    ``worker=None`` (default) yields the Eq. 11 weighted global model with
    ``alpha`` weights (uniform if omitted); ``worker=i`` yields worker i's
    own model, bit for bit its training-time params."""
    dev = resolve_device(device, "serving_params_from_checkpoint")
    blobs, extra = _read_fleet(path, ("params|pbuf",))    # not the opt
    pbuf = blobs["params|pbuf"]
    ck_arch = (extra.get("config") or {}).get("arch")
    if ck_arch is not None and ck_arch != cfg.arch_id:
        raise ValueError(f"checkpoint was trained on arch {ck_arch!r}, "
                         f"got cfg for {cfg.arch_id!r}")
    spec = fleet_spec_for(cfg)
    n, p = pbuf.shape
    if p != spec.n_params:
        raise ValueError(f"checkpoint flat width P={p} does not match "
                         f"{cfg.arch_id} ({spec.n_params} params) — wrong "
                         f"config geometry for this snapshot")
    if worker is not None:
        if not 0 <= worker < n:
            raise ValueError(f"worker {worker} out of range for fleet N={n}")
        row = torch.from_numpy(np.array(pbuf[worker])).to(dev)
    else:
        if alpha is None:
            alpha = np.full((n,), 1.0 / n, np.float32)
        alpha = np.asarray(alpha, np.float32)
        if alpha.shape != (n,):
            raise ValueError(f"alpha must be shape ({n},), got {alpha.shape}")
        row = FS.weighted_row(torch.from_numpy(np.array(pbuf)).to(dev),
                              torch.from_numpy(alpha).to(dev))
    return FS.unravel_tree(row, spec, copy=True)


def engine_from_checkpoint(path: str | pathlib.Path, cfg: ModelConfig,
                           worker: Optional[int] = None,
                           alpha: Optional[np.ndarray] = None,
                           batch_slots: int = 4, max_len: int = 512,
                           seed: int = 0, device="cuda") -> ServeEngine:
    """One call: checkpoint -> serving engine on ``device``."""
    params = serving_params_from_checkpoint(path, cfg, worker=worker,
                                            alpha=alpha, device=device)
    return ServeEngine(cfg, params, batch_slots=batch_slots, max_len=max_len,
                       seed=seed, device=device)

"""Checkpointing: trees of tensors and numpy arrays -> one ``.npz`` (the port
of ``repro.checkpoint.io``, in its file layout, so a snapshot either package
writes loads in the other).

Layout: every leaf of the ``params`` tree is stored under
``params|<path>`` and every leaf of the optional ``opt`` tree under
``opt|<path>``, the path's keys and list indices joined with ``/`` in
``jax.tree_util.tree_flatten_with_path`` order (``tree.tree_paths``).  A
bf16 leaf is stored as its uint16 bits under ``<key>::bf16``; the
``extra`` metadata is json under ``__meta__``.  The write is atomic (a
temporary file, then ``os.replace``), so the newest snapshot in a
directory is always whole.  Restoring fills a template tree: numpy leaves
come back as numpy arrays of the template's dtype (int64 and float64
control-plane state stays exact), tensor leaves as tensors of the
template's dtype on the template's device.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_paths


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """A leaf's host array, and whether it is bf16 (stored as uint16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(leaf), False


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for path, leaf in tree_paths(tree):
        arr, bf16 = _to_numpy(leaf)
        flat[_key(path) + ("::bf16" if bf16 else "")] = arr
    return flat


def save_checkpoint(path: str | pathlib.Path, params: Any,
                    opt_state: Optional[Any] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blobs = {}
    for name, tree in (("params", params), ("opt", opt_state)):
        if tree is None:
            continue
        for k, v in _flatten_with_paths(tree).items():
            blobs[f"{name}|{k}"] = v
    meta = {"extra": _jsonify(extra or {})}
    tmp = path.with_name(path.name + f".tmp-{os.getpid()}.npz")
    try:
        np.savez(tmp, __meta__=json.dumps(meta), **blobs)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def read_checkpoint(path: str | pathlib.Path,
                    keys: Optional[Iterable[str]] = None
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """A snapshot's stored arrays by key (all of them, or only ``keys``:
    the others are never read from disk) and its ``extra`` metadata."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        names = [k for k in z.files if k != "__meta__"] if keys is None \
            else list(keys)
        blobs = {k: z[k] for k in names if k in z.files}
    return blobs, meta.get("extra", {})


def _restore_leaf(arr: np.ndarray, bf16: bool, leaf, full: str):
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
    if tuple(arr.shape) != shape:
        raise ValueError(f"checkpoint leaf {full} has shape {arr.shape}, "
                         f"the template {shape}")
    if isinstance(leaf, torch.Tensor):
        arr = arr if arr.flags.c_contiguous else arr.copy()
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if bf16 else torch.from_numpy(arr))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if bf16:
        # numpy has no bf16: widen the bits to f32 exactly
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def load_checkpoint(path: str | pathlib.Path, params_template: Any,
                    opt_template: Optional[Any] = None
                    ) -> Tuple[Any, Optional[Any], Dict[str, Any]]:
    """Restore into the templates' tree structure, dtypes and devices; a
    leaf the snapshot lacks raises ``KeyError`` naming it."""
    blobs, extra = read_checkpoint(path)

    def restore(tree, prefix, path_=()):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: restore(v, prefix, path_ + (k,))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [restore(v, prefix, path_ + (i,))
                    for i, v in enumerate(tree)]
        full = f"{prefix}|{_key(path_)}"
        if full + "::bf16" in blobs:
            return _restore_leaf(blobs[full + "::bf16"], True, tree, full)
        if full in blobs:
            return _restore_leaf(blobs[full], False, tree, full)
        raise KeyError(f"checkpoint missing {full}")

    params = restore(params_template, "params")
    opt = restore(opt_template, "opt") if opt_template is not None else None
    return params, opt, extra


def _jsonify(obj):
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    return obj


# -- checkpoint directories --------------------------------------------------
# One file per snapshot, ``ckpt_round{t:06d}.npz``; the atomic write above
# means the newest file in the directory is always complete — a kill mid-save
# leaves only a ``.tmp-*`` file, never a truncated checkpoint.

_CKPT_RE = re.compile(r"^ckpt_round(\d+)\.npz$")


def checkpoint_path(ckpt_dir: str | pathlib.Path, t: int) -> pathlib.Path:
    """Canonical snapshot filename for round ``t``."""
    return pathlib.Path(ckpt_dir) / f"ckpt_round{int(t):06d}.npz"


def list_checkpoints(ckpt_dir: str | pathlib.Path) -> List[pathlib.Path]:
    """All snapshots in ``ckpt_dir``, oldest round first."""
    d = pathlib.Path(ckpt_dir)
    if not d.is_dir():
        return []
    found = [(int(m.group(1)), p) for p in d.iterdir()
             if (m := _CKPT_RE.match(p.name))]
    return [p for _, p in sorted(found)]


def latest_checkpoint(ckpt_dir: str | pathlib.Path
                      ) -> Optional[pathlib.Path]:
    """Newest complete snapshot in ``ckpt_dir`` (None if there are none)."""
    cks = list_checkpoints(ckpt_dir)
    return cks[-1] if cks else None


def resolve_snapshot(resume_from: str | pathlib.Path) -> pathlib.Path:
    """A snapshot file as given, or a checkpoint directory's newest one
    (``FileNotFoundError`` if the directory holds none)."""
    ck = pathlib.Path(resume_from)
    if ck.is_dir():
        found = latest_checkpoint(ck)
        if found is None:
            raise FileNotFoundError(
                f"resume_from={ck} is a directory with no "
                f"ckpt_round*.npz snapshot in it")
        ck = found
    return ck


def check_resume_config(ck: pathlib.Path, extra: Dict[str, Any],
                        want: Dict[str, Any]) -> None:
    """Raise ``ValueError`` unless the snapshot ``ck`` (its ``extra``
    metadata) was written by a run of the configuration ``want``; only the
    fields the snapshot recorded are compared."""
    saved = extra.get("config", {})
    for k, v in want.items():
        if k in saved and saved[k] != v:
            raise ValueError(
                f"resume config mismatch: snapshot {ck.name} was written "
                f"with {k}={saved[k]!r} but this run has {k}={v!r} — "
                f"resuming must use the identical configuration")


def prune_checkpoints(ckpt_dir: str | pathlib.Path, keep: int = 3) -> None:
    """Delete all but the ``keep`` newest snapshots (and stale .tmp files)."""
    cks = list_checkpoints(ckpt_dir)
    for p in cks[:max(0, len(cks) - keep)]:
        p.unlink(missing_ok=True)
    d = pathlib.Path(ckpt_dir)
    if d.is_dir():
        for p in d.glob("*.tmp-*.npz"):
            p.unlink(missing_ok=True)

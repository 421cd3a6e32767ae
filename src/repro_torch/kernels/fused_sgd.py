"""Eq. 5 fused multi-step local SGD — CUDA kernel and plain version.

The port of ``repro.kernels.fused_sgd.fused_sgd`` (a TPU kernel) and of the
JAX engine's jnp lowering ``repro.dfl.worker.local_sgd_flat_fused``, which is
this module's plain version.  ``fused_sgd`` launches ``csrc/fused_sgd.cu`` on
CUDA tensors (one block per gathered worker row) and runs
``local_sgd_flat_fused`` on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.dfl import flat_state as FS
from repro_torch.kernels import _build

LEAVES = ("b1", "b2", "b3", "w1", "w2", "w3")   # FlatSpec column order
SMEM_LIMIT = 232448                    # dynamic shared memory of one block

_SIGNATURES = {
    "repro_fused_sgd_f32": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
    "repro_fused_sgd_smem_bytes": (ctypes.c_longlong, [ctypes.c_int] * 5),
}


launches = 0      # CUDA launches of this kernel; callers zero it to count a run
launches_sharded = 0      # ... of those made by fused_sgd_sharded

def local_sgd_flat_fused(buf: torch.Tensor, xb: torch.Tensor,
                         yb: torch.Tensor, active: torch.Tensor,
                         spec: FS.FlatSpec, lr: float,
                         with_losses: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused multi-step SGD (Eq. 5) on gathered rows: the plain version.

    buf (k, P) rows of the flat buffer, xb (k, steps, batch, dim), yb
    (k, steps, batch) labels, active (k,).  Each row takes ``steps`` SGD
    steps of the 3-layer ReLU MLP with the closed-form cross-entropy
    backward ``softmax(logits) - onehot``, scaled by ``active * lr`` — an
    inactive row comes back bit-identical and still reports its loss.
    Returns the new (k, P) rows and the (k,) mean loss over steps (zeros
    when ``with_losses=False``, which skips the log-sum-exp chain).
    Requires ``dfl.worker.fused_sgd_supported(spec)``.
    """
    p = FS.unflatten(buf.float(), spec)
    w1, b1, w2, b2 = p["w1"], p["b1"], p["w2"], p["b2"]
    w3, b3 = p["w3"], p["b3"]
    n_classes = w3.shape[-1]
    batch = xb.shape[2]
    a = active.float() * lr
    sw = a[:, None, None]                      # (k, 1, 1) weight-update scale
    sb = a[:, None]                            # (k, 1)    bias-update scale
    classes = torch.arange(n_classes, device=buf.device)
    losses = []
    for s in range(xb.shape[1]):
        x, y = xb[:, s].float(), yb[:, s]
        z1 = torch.bmm(x, w1) + b1[:, None]
        h1 = torch.relu(z1)
        z2 = torch.bmm(h1, w2) + b2[:, None]
        h2 = torch.relu(z2)
        logits = torch.bmm(h2, w3) + b3[:, None]
        onehot = (y[..., None] == classes).float()   # out-of-range label: 0s
        if with_losses:
            logp = torch.log_softmax(logits, dim=-1)
            losses.append(-(logp * onehot).sum(-1).mean(-1))
            probs = torch.exp(logp)
        else:
            probs = torch.softmax(logits, dim=-1)
        dz = (probs - onehot) / batch          # d(mean CE)/d logits
        g_w3 = torch.bmm(h2.transpose(1, 2), dz)
        g_b3 = dz.sum(1)
        dh2 = torch.bmm(dz, w3.transpose(1, 2)) * (z2 > 0)
        g_w2 = torch.bmm(h1.transpose(1, 2), dh2)
        g_b2 = dh2.sum(1)
        dh1 = torch.bmm(dh2, w2.transpose(1, 2)) * (z1 > 0)
        g_w1 = torch.bmm(x.transpose(1, 2), dh1)
        g_b1 = dh1.sum(1)
        w1, b1 = w1 - sw * g_w1, b1 - sb * g_b1
        w2, b2 = w2 - sw * g_w2, b2 - sb * g_b2
        w3, b3 = w3 - sw * g_w3, b3 - sb * g_b3
    new = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    out, _ = FS.flatten_stacked(new)
    loss = (torch.stack(losses).mean(0) if with_losses
            else torch.zeros((buf.shape[0],), dtype=torch.float32,
                             device=buf.device))
    return out, loss


def _layout(spec: FS.FlatSpec):
    if spec.keys != LEAVES:
        raise ValueError(f"fused_sgd: spec leaves {spec.keys} are not the "
                         f"3-layer MLP {LEAVES}")
    off = dict(zip(spec.keys, spec.offsets))
    shp = dict(zip(spec.keys, spec.shapes))
    (d, h), (_, g), (_, c) = shp["w1"], shp["w2"], shp["w3"]
    return [off[n] for n in ("b1", "b2", "b3", "w1", "w2", "w3")] + [d, h, g,
                                                                     c]


def fused_sgd(buf: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor,
              active: torch.Tensor, spec: FS.FlatSpec, lr: float,
              with_losses: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``local_sgd_flat_fused``'s contract, on the CUDA kernel for CUDA
    tensors (contiguous f32 ``buf``/``xb``, int32 ``yb``) and on the plain
    version for CPU tensors.  Counts its kernel launches in the
    module's ``launches``."""
    k, p = buf.shape
    if k == 0:
        raise ValueError("fused_sgd: no rows (k = 0) — callers skip local "
                         "training when no worker is activated")
    if xb.dim() != 4 or tuple(yb.shape) != tuple(xb.shape[:3]) \
            or xb.shape[0] != k or tuple(active.shape) != (k,):
        raise ValueError(f"fused_sgd: expected xb (k, steps, batch, dim), yb "
                         f"(k, steps, batch), active (k,) for k={k}; got "
                         f"{tuple(xb.shape)}, {tuple(yb.shape)}, "
                         f"{tuple(active.shape)}")
    if p != spec.n_params:
        raise ValueError(f"fused_sgd: rows have {p} columns, spec {spec.n_params}")
    for name, t in (("xb", xb), ("yb", yb), ("active", active)):
        if t.device != buf.device:
            raise ValueError(f"fused_sgd: {name} is on {t.device}, buf on "
                             f"{buf.device}")
    if buf.device.type == "cpu":
        return local_sgd_flat_fused(buf, xb, yb, active, spec, lr,
                                    with_losses=with_losses)
    if buf.device.type != "cuda":
        raise ValueError(f"fused_sgd: no kernel for device {buf.device}")
    for name, t, dtype in (("buf", buf, torch.float32),
                           ("xb", xb, torch.float32),
                           ("yb", yb, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"fused_sgd: the CUDA kernel needs a contiguous "
                             f"{dtype} {name}, got {t.dtype} "
                             f"(contiguous={t.is_contiguous()})")
    layout = _layout(spec)
    d = layout[6]
    steps, batch = xb.shape[1], xb.shape[2]
    if xb.shape[3] != d:
        raise ValueError(f"fused_sgd: xb dim {xb.shape[3]} != w1 rows {d}")
    lib = _build.load("fused_sgd", _SIGNATURES)
    smem = lib.repro_fused_sgd_smem_bytes(batch, *layout[6:])
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_sgd: one step's activations need {smem} B "
                         f"of shared memory, a block has {SMEM_LIMIT}")
    scale = (active.float() * lr).contiguous()
    out = torch.empty((k, p), dtype=torch.float32, device=buf.device)
    loss = torch.empty((k,), dtype=torch.float32, device=buf.device)
    c_layout = (ctypes.c_int * 10)(*layout)
    with torch.cuda.device(buf.device):
        err = lib.repro_fused_sgd_f32(
            buf.data_ptr(), xb.data_ptr(), yb.data_ptr(), scale.data_ptr(),
            out.data_ptr(), loss.data_ptr(), k, p, c_layout, steps, batch,
            int(with_losses), torch.cuda.current_stream(buf.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_sgd kernel launch failed: CUDA error {err} "
                           f"(k={k}, P={p}, steps={steps}, batch={batch})")
    global launches
    launches += 1
    return out, loss


def fused_sgd_sharded(buf: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor,
                      active: torch.Tensor, spec: FS.FlatSpec, lr: float,
                      with_losses: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 5 on a mesh rank's home rows: the port of
    ``repro.kernels.fused_sgd.fused_sgd_sharded``.  Local SGD is row-local,
    so the SPMD program needs no collective: each rank runs ``fused_sgd`` on
    its own segment of the gathered rows (``FleetSharding.for_rows``) and
    their minibatches, and a rank with no rows in the segment returns empty
    results without a launch.  Its plain version is
    ``local_sgd_flat_fused`` on the whole gathered set."""
    if buf.shape[0] == 0:
        return buf.new_empty((0, buf.shape[1])), buf.new_zeros((0,))
    out = fused_sgd(buf, xb, yb, active, spec, lr, with_losses)
    if buf.device.type == "cuda":
        global launches_sharded
        launches_sharded += 1
    return out

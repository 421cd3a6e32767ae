"""Worker-side model and the fused round engine of the simulation plane.

The simulation plane trains a 3-layer MLP classifier (the offline stand-in
for the paper's CNN).  All N worker replicas live in ONE flat (N, P) f32
tensor (``flat_state``); a simulated round is Eq. 4 mixing of the k
non-identity rows (``kernels.aggregate``) followed by masked local SGD
(Eq. 5) on the activated rows (``kernels.fused_sgd``), written back into the
buffer in place with ``index_copy_``.  ``mega_round_step`` runs a whole
planned horizon of rounds back to back.

Default hot paths (each with a flag-gated slower oracle, as in the JAX
package):
  * column-sparse mixing — Eq. 4 contracts (k, u) @ (u, P) over the gathered
    union of nonzero columns (``mix_flat_cols``; oracle ``mix_flat``);
  * fused local-steps SGD — Eq. 5 as one kernel over the gathered active
    rows (``kernels.fused_sgd``; oracle ``local_sgd_flat``, per-step
    autograd).

Minibatches are drawn on the host with one explicit ``torch.Generator``
stream per (seed, round, worker id) — ``sample_batch_ids`` — so a worker's
batch does not depend on its bucket position, the horizon split, the
pipeline depth or the device, and the indices ship with the chunk.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import (bucket_size, col_union_mask,
                                          mixing_rows, mixing_rows_cols,
                                          padded_rows, plan_buckets)
from repro_torch.dfl import flat_state as FS
from repro_torch.kernels import aggregate as AGG
from repro_torch.kernels import fused_sgd as FSGD
from repro_torch.kernels.config import KernelConfig
from repro_torch.kernels.fused_sgd import local_sgd_flat_fused  # noqa: F401

Params = Dict[str, torch.Tensor]

BATCH_STREAM = 0x5EED           # batch streams are keyed off seed + this


def init_mlp(gen: torch.Generator, dim: int, hidden: int,
             n_classes: int) -> Params:
    """One MLP, scaled-normal weights drawn from ``gen``, zero biases."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32)

    return {
        "w1": normal(dim, hidden) * dim ** -0.5,
        "b1": torch.zeros((hidden,), dtype=torch.float32),
        "w2": normal(hidden, hidden) * hidden ** -0.5,
        "b2": torch.zeros((hidden,), dtype=torch.float32),
        "w3": normal(hidden, n_classes) * hidden ** -0.5,
        "b3": torch.zeros((n_classes,), dtype=torch.float32),
    }


def init_stacked(gen: torch.Generator, n_workers: int, dim: int, hidden: int,
                 n_classes: int) -> Params:
    """All workers start from one w_0 (paper Thm. 1 assumes shared init)."""
    p = init_mlp(gen, dim, hidden, n_classes)
    return {k: v[None].expand((n_workers,) + v.shape).clone()
            for k, v in p.items()}


def mlp_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    return h @ p["w3"] + p["b3"]


def mlp_loss(p: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(mlp_logits(p, x), dim=-1)
    return -torch.take_along_dim(logp, y[:, None].long(), dim=-1).mean()


def param_bytes(params: Params) -> int:
    return sum(v.numel() * v.element_size() for v in params.values())


def _acc_loss(logits: torch.Tensor, y: torch.Tensor):
    acc = (logits.argmax(-1) == y).float().mean(-1)
    logp = torch.log_softmax(logits, dim=-1)
    y_idx = y.long().expand(logits.shape[:-1])[..., None]
    loss = -torch.take_along_dim(logp, y_idx, dim=-1)[..., 0].mean(-1)
    return acc, loss


@torch.no_grad()
def evaluate_global_flat(buf: torch.Tensor, alpha: torch.Tensor,
                         x: torch.Tensor, y: torch.Tensor, *,
                         spec: FS.FlatSpec
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 11 global-model accuracy and loss straight off the flat buffer:
    the global model is one ``alpha @ buf`` product, unravelled."""
    gm = FS.unravel_row(FS.weighted_row(buf, alpha), spec)
    return _acc_loss(mlp_logits(gm, x), y)


@torch.no_grad()
def evaluate_stacked_flat(buf: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor, *, spec: FS.FlatSpec
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean local-model test accuracy and loss over all buffer rows."""
    p = FS.unflatten(buf, spec)
    h = torch.relu(torch.matmul(x, p["w1"]) + p["b1"][:, None])
    h = torch.relu(torch.bmm(h, p["w2"]) + p["b2"][:, None])
    logits = torch.bmm(h, p["w3"]) + p["b3"][:, None]        # (N, n, C)
    acc, loss = _acc_loss(logits, y)
    return acc.mean(), loss.mean()


# --------------------------------------------------------------------------- #
# Eq. 4: mixing
# --------------------------------------------------------------------------- #


def _mix_rows(buf: torch.Tensor, w_rows: torch.Tensor, col_ids,
              kernels: Optional[KernelConfig]) -> torch.Tensor:
    """The Eq. 4 contraction of the k gathered rows: (k, N) @ (N, P), or the
    column-sparse (k, u) @ buf[col_ids] when ``col_ids`` is given — one
    ``kernels.aggregate`` call either way."""
    p_blk = (kernels or KernelConfig()).agg_p_blk
    return AGG.aggregate(w_rows, buf, col_ids, p_blk=p_blk)


def mix_flat(buf: torch.Tensor, w_rows: torch.Tensor, row_ids: torch.Tensor,
             kernels: Optional[KernelConfig] = None) -> torch.Tensor:
    """Row-sparse Eq. 4 over the flat buffer, in place: mix the k
    non-identity rows only (every other row of W is identity)."""
    if w_rows.shape[0] == 0:
        return buf
    return buf.index_copy_(0, row_ids.long(),
                           _mix_rows(buf, w_rows, None, kernels))


def mix_flat_cols(buf: torch.Tensor, w_sub: torch.Tensor,
                  row_ids: torch.Tensor, col_ids: torch.Tensor,
                  kernels: Optional[KernelConfig] = None) -> torch.Tensor:
    """Column-sparse Eq. 4 over the flat buffer, in place (the default mix
    path): ``w_sub`` (k, u) are the non-identity rows of W restricted to the
    union of their nonzero columns ``col_ids`` (u,); padding columns of
    ``w_sub`` are zero, so the product is exact."""
    if w_sub.shape[0] == 0:
        return buf
    return buf.index_copy_(0, row_ids.long(),
                           _mix_rows(buf, w_sub, col_ids, kernels))


# --------------------------------------------------------------------------- #
# Eq. 5: local SGD
# --------------------------------------------------------------------------- #


def mlp_loss_flat(vec: torch.Tensor, spec: FS.FlatSpec, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """MLP loss on one worker's (P,) slice of the flat buffer."""
    return mlp_loss(FS.unravel_row(vec, spec), x, y)


def local_sgd_flat(buf: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor,
                   active: torch.Tensor, spec: FS.FlatSpec, lr: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked per-worker SGD (Eq. 5) on flat rows by autograd: the oracle of
    the fused lowering.  xb (k, steps, batch, dim), yb (k, steps, batch),
    active (k,); returns the new rows and each row's mean loss."""
    from torch.func import grad_and_value, vmap

    def per_worker(vec, x_steps, y_steps, a):
        losses = []
        for s in range(x_steps.shape[0]):
            g, loss = grad_and_value(mlp_loss_flat)(vec, spec, x_steps[s],
                                                    y_steps[s])
            vec = vec - (lr * a) * g
            losses.append(loss)
        return vec, torch.stack(losses).mean()

    return vmap(per_worker)(buf.float(), xb, yb, active.float())


def fused_sgd_supported(spec: FS.FlatSpec) -> bool:
    """True iff ``spec`` is the sim-plane 3-layer MLP (``init_mlp`` layout)
    that the fused SGD kernel differentiates by hand; any other model runs
    the autograd oracle ``local_sgd_flat``."""
    if spec.keys != FSGD.LEAVES:
        return False
    shapes = dict(zip(spec.keys, spec.shapes))
    return (len(shapes["w1"]) == len(shapes["w2"]) == len(shapes["w3"]) == 2
            and shapes["w1"][1] == shapes["b1"][0] == shapes["w2"][0]
            and shapes["w2"][1] == shapes["b2"][0] == shapes["w3"][0]
            and shapes["w3"][1] == shapes["b3"][0])


# --------------------------------------------------------------------------- #
# host-side packing of planned rounds
# --------------------------------------------------------------------------- #


def pack_round_ctrl(mix_row_ids: np.ndarray, train_row_ids: np.ndarray,
                    train_mask: np.ndarray,
                    col_ids: Optional[np.ndarray] = None) -> np.ndarray:
    """Concatenate one round's integer control vectors into ONE host array
    (one host-to-device copy instead of three).  Layout: ``[mix_row_ids (k,)
    | col_ids (u,) if column-sparse | train_row_ids (k_train,) | train_mask
    (k_train,)]`` — ``split_ctrl`` recovers the segments from the W shape."""
    segs = [np.asarray(mix_row_ids, np.int32)]
    if col_ids is not None:
        segs.append(np.asarray(col_ids, np.int32))
    segs += [np.asarray(train_row_ids, np.int32),
             np.asarray(train_mask, np.int32)]
    return np.concatenate(segs)


def split_ctrl(ctrl: torch.Tensor, k_mix: int, u: int):
    """The ``pack_round_ctrl`` segments of a packed control vector (or of a
    stacked ``(H, ·)`` horizon of them, sliced along the last axis):
    ``(mix_ids, col_ids | None, train_ids, train_mask)`` with the mask as
    f32."""
    k_train = (ctrl.shape[-1] - k_mix - u) // 2
    mix_ids = ctrl[..., :k_mix]
    col_ids = ctrl[..., k_mix:k_mix + u] if u else None
    train_ids = ctrl[..., k_mix + u:k_mix + u + k_train]
    train_mask = ctrl[..., k_mix + u + k_train:].to(torch.float32)
    return mix_ids, col_ids, train_ids, train_mask


def pack_horizon(plans, min_bucket: int = 8, col_sparse: bool = False,
                 shards: int = 1
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack H planned rounds' control tensors for ``mega_round_step``.

    ``plans``: objects with ``.W (N, N)``, ``.active (N,)``, ``.links
    (N, N)``, ``.t`` (``core.planner.PlannedRound``, duck-typed).  All rounds
    of a chunk share one shape: each is padded to the horizon-wide max of
    the per-round power-of-two buckets.  Padding rows are exact no-ops:
    identity W rows / zero train masks targeting workers idle in that round.
    ``col_sparse=True`` restricts W rows to the horizon-max bucket of each
    round's nonzero-column union, whose ``col_ids`` ride in ``ctrl``.

    Returns ``(w_rows (H, K_mix, N | U) f32, ctrl (H, K_mix [+ U] +
    2*K_train) i32, ts (H,) i32)``.
    """
    n = plans[0].W.shape[0]
    buckets = [plan_buckets(p.active, p.links, min_bucket) for p in plans]
    k_mix = max(b[0] for b in buckets)
    k_train = max(b[1] for b in buckets)
    h = len(plans)
    ts = np.zeros((h,), np.int32)
    if col_sparse:
        def cols_of(p):
            return (p.mix_cols if getattr(p, "mix_cols", None) is not None
                    else col_union_mask(p.active, p.links, shards))

        u = max(bucket_size(int(cols_of(p).sum()), n, min_bucket)
                for p in plans) if k_mix else 0
        if u >= n:
            u = n
        w_rows_h = np.zeros((h, k_mix, u), np.float32)
        ctrl_h = np.zeros((h, k_mix + u + 2 * k_train), np.int32)
        for i, p in enumerate(plans):
            w_sub, mix_ids, col_ids = mixing_rows_cols(
                p.W, p.active, p.links, min_bucket, pad_to=k_mix,
                col_pad_to=u, cols_mask=cols_of(p), shards=shards)
            train_ids, train_mask = padded_rows(p.active, min_bucket,
                                                pad_to=k_train, shards=shards)
            if k_mix:
                w_rows_h[i] = w_sub
            ctrl_h[i] = pack_round_ctrl(mix_ids, train_ids, train_mask,
                                        col_ids=col_ids)
            ts[i] = p.t
        return w_rows_h, ctrl_h, ts
    w_rows_h = np.zeros((h, k_mix, n), np.float32)
    ctrl_h = np.zeros((h, k_mix + 2 * k_train), np.int32)
    for i, p in enumerate(plans):
        w_rows, mix_ids = mixing_rows(p.W, p.active, p.links, min_bucket,
                                      pad_to=k_mix, shards=shards)
        train_ids, train_mask = padded_rows(p.active, min_bucket,
                                            pad_to=k_train, shards=shards)
        if k_mix:
            w_rows_h[i] = w_rows
        ctrl_h[i] = pack_round_ctrl(mix_ids, train_ids, train_mask)
        ts[i] = p.t
    return w_rows_h, ctrl_h, ts


def pack_chunk(plans, key, *, min_bucket: int = 8, col_sparse: bool = False,
               shards: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``pack_horizon`` specialized to a bucket-uniform ``chunk_spans`` chunk.

    Every plan of a chunk shares the ``bucket_key`` triple ``key``, so the
    padded shapes are ``key`` itself and the per-plan bucket re-derivation
    collapses into one direct loop over the planner-resolved row sets
    (``PlannedRound.mix_rows``/``train_rows``/``mix_pad``/``train_pad``).
    Output is bit-identical to ``pack_horizon`` on the same chunk.  Falls
    back to ``pack_horizon`` for all-idle chunks (``k_mix == 0``) and the
    full-width column union (``u >= N``, where ``col_ids = arange(N)``).
    """
    n = plans[0].W.shape[0]
    k_mix, k_train = int(key[0]), int(key[1])
    u = int(key[2]) if col_sparse and len(key) > 2 else 0
    if shards > 1 or k_mix == 0 or (col_sparse and u >= n):
        return pack_horizon(plans, min_bucket=min_bucket,
                            col_sparse=col_sparse, shards=shards)
    h = len(plans)
    w = np.zeros((h, k_mix, u if col_sparse else n), np.float32)
    ctrl = np.empty((h, k_mix + (u if col_sparse else 0) + 2 * k_train),
                    np.int32)
    ts = np.empty((h,), np.int32)
    for i, p in enumerate(plans):
        rows = (p.mix_rows if getattr(p, "mix_rows", None) is not None
                else np.flatnonzero(p.active | p.links.any(axis=1)))
        k = len(rows)
        if k_mix > k:
            # the unsharded padding rule: the globally-first idle row,
            # repeated (``PlannedRound.mix_pad`` when the planner resolved it)
            cand = getattr(p, "mix_pad", None)
            if cand is None:
                mask = np.zeros(n, bool)
                mask[rows] = True
                cand = np.flatnonzero(~mask)[:1]
            rows = np.concatenate(
                [rows, cand[np.arange(k_mix - k) % len(cand)]])
        if col_sparse:
            cols = np.flatnonzero(
                p.mix_cols if getattr(p, "mix_cols", None) is not None
                else col_union_mask(p.active, p.links, shards))
            ut = len(cols)
            col_ids = (np.concatenate([cols, np.zeros(u - ut, cols.dtype)])
                       if u > ut else cols)
            sub = p.W[rows[:, None], col_ids[None, :]]
            sub[:, ut:] = 0.0          # padded columns contribute nothing
            w[i] = sub
        else:
            w[i] = p.W[rows]
        trows = (p.train_rows if getattr(p, "train_rows", None) is not None
                 else np.flatnonzero(p.active))
        kt = len(trows)
        if k_train > kt:
            cand = getattr(p, "train_pad", None)
            if cand is None:
                cand = np.flatnonzero(~p.active)[:1]
            trows = np.concatenate(
                [trows, cand[np.arange(k_train - kt) % len(cand)]])
        c = ctrl[i]
        c[:k_mix] = rows
        off = k_mix
        if col_sparse:
            c[off:off + u] = col_ids
            off += u
        c[off:off + k_train] = trows
        c[off + k_train:] = p.active[trows]
        ts[i] = p.t
    return w, ctrl, ts


def _stream_seed(base: int, t: int, worker: int) -> int:
    """A 64-bit generator seed for the (base, round, worker) batch stream:
    splitmix64 finalization of each key word in turn."""
    z = 0
    for word in (base, t, worker):
        z = (z ^ (word & 0xFFFFFFFFFFFFFFFF)) + 0x9E3779B97F4A7C15
        z &= 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        z ^= z >> 31
    return z


def sample_batch_ids(seed: int, ts: Sequence[int], train_ids: np.ndarray,
                     parts: Sequence[np.ndarray], local_steps: int,
                     batch_size: int) -> np.ndarray:
    """Minibatch sample indices for a chunk of rounds, drawn on the host.

    ``train_ids`` (H, k) are each round's gathered train rows (padding rows
    included: their batches are drawn and ignored), ``parts`` each worker's
    sample indices into the training set.  Worker w's draw in round t comes
    from its own ``torch.Generator`` seeded by (seed + 0x5EED, t, w) — uniform
    over its partition — so it is the same whatever bucket, chunk, pipeline
    depth or device the round runs at.  Returns (H, k, steps, batch) int64.
    """
    h, k = train_ids.shape
    out = np.empty((h, k, local_steps, batch_size), np.int64)
    gen = torch.Generator()
    base = seed + BATCH_STREAM
    for i in range(h):
        for j in range(k):
            w = int(train_ids[i, j])
            gen.manual_seed(_stream_seed(base, int(ts[i]), w))
            r = torch.randint(0, len(parts[w]), (local_steps, batch_size),
                              generator=gen)
            out[i, j] = parts[w][r.numpy()]
    return out


# --------------------------------------------------------------------------- #
# the round engine
# --------------------------------------------------------------------------- #


def _mix_train_body(buf: torch.Tensor, w_rows: torch.Tensor,
                    mix_row_ids: torch.Tensor, col_ids,
                    train_row_ids: torch.Tensor, train_mask: torch.Tensor,
                    xb, yb, spec: FS.FlatSpec, lr: float,
                    kernels: Optional[KernelConfig], fused_sgd: bool,
                    with_losses: bool = True, mix_is_train: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix + masked SGD of one round on pre-drawn batches, in place on
    ``buf``.  ``col_ids`` non-None selects the column-sparse contraction;
    ``fused_sgd`` the fused SGD kernel (else the autograd oracle).

    ``mix_is_train`` (host-verified: the mix row ids EQUAL the train row
    ids, as in every DySTop round) feeds the Eq. 4 output straight into
    Eq. 5, skipping the write-back and re-gather of the same rows.  Returns
    (buf, per-worker mean losses (N,), zero for idle workers)."""
    n = buf.shape[0]
    k_train = train_row_ids.shape[0]

    def train_rows(sub):
        if fused_sgd:
            return FSGD.fused_sgd(sub, xb, yb, train_mask, spec, lr,
                                  with_losses=with_losses)
        return local_sgd_flat(sub, xb, yb, train_mask, spec, lr)

    losses = torch.zeros((n,), dtype=torch.float32, device=buf.device)
    tids = train_row_ids.long()
    if fused_sgd and mix_is_train and k_train > 0 and w_rows.shape[0] > 0:
        new_sub, sub_loss = train_rows(_mix_rows(buf, w_rows, col_ids,
                                                 kernels))
    else:
        if col_ids is not None:
            mix_flat_cols(buf, w_rows, mix_row_ids, col_ids, kernels)
        else:
            mix_flat(buf, w_rows, mix_row_ids, kernels)
        if k_train == 0:
            return buf, losses
        new_sub, sub_loss = train_rows(buf.index_select(0, tids))
    buf.index_copy_(0, tids, new_sub)
    if with_losses:
        losses.index_copy_(0, tids, sub_loss * train_mask)
    return buf, losses


def round_step(buf: torch.Tensor, w_rows: torch.Tensor, ctrl: torch.Tensor,
               xb, yb, *, spec: FS.FlatSpec, lr: float,
               kernels: Optional[KernelConfig] = None,
               col_sparse: bool = False, fused_sgd: bool = False,
               with_losses: bool = True, mix_is_train: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One simulated round on the device: sparse mix + local SGD, in place.

    ``w_rows`` are the (k, N) non-identity rows of W, or with ``col_sparse``
    the (k, u) rows restricted to the column union; ``ctrl`` is the
    ``pack_round_ctrl`` vector; ``xb`` (k_train, steps, batch, dim) / ``yb``
    the train rows' minibatches (None when no row trains).  Returns (buf,
    per-worker mean loss (N,), zero for idle workers)."""
    k_mix = w_rows.shape[0]
    u = w_rows.shape[1] if col_sparse and k_mix else 0
    mix_ids, col_ids, train_ids, mask = split_ctrl(ctrl, k_mix, u)
    return _mix_train_body(buf, w_rows, mix_ids, col_ids, train_ids, mask,
                           xb, yb, spec, lr, kernels, fused_sgd, with_losses,
                           mix_is_train)


def mega_round_step(buf: torch.Tensor, w_rows: torch.Tensor,
                    ctrl: torch.Tensor, xb, yb, *, spec: FS.FlatSpec,
                    lr: float, kernels: Optional[KernelConfig] = None,
                    col_sparse: bool = False, fused_sgd: bool = False,
                    with_losses: bool = True, mix_is_train: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H horizon-planned rounds back to back, in place on ``buf``.

    Inputs are the ``pack_horizon``/``pack_chunk`` stacks — ``w_rows
    (H, K_mix, N | U)``, ``ctrl (H, ·)`` — and the chunk's minibatches
    ``xb (H, K_train, steps, batch, dim)``/``yb`` (None when no row trains).
    Returns (buf, (H, N) per-round losses)."""
    losses = []
    for h in range(w_rows.shape[0]):
        buf, loss = round_step(
            buf, w_rows[h], ctrl[h], None if xb is None else xb[h],
            None if yb is None else yb[h], spec=spec, lr=lr,
            kernels=kernels, col_sparse=col_sparse, fused_sgd=fused_sgd,
            with_losses=with_losses, mix_is_train=mix_is_train)
        losses.append(loss)
    return buf, torch.stack(losses)

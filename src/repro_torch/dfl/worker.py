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
                         spec: FS.FlatSpec, shd=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 11 global-model accuracy and loss straight off the flat buffer:
    the global model is one ``alpha @ buf`` product, unravelled.  With
    ``shd`` the buffer and ``alpha`` are this rank's block (padding rows
    weigh 0) and one all-reduce sums the ranks' partial products."""
    row = FS.weighted_row(buf, alpha)
    if shd is not None:
        shd.psum(row)
    return _acc_loss(mlp_logits(FS.unravel_row(row, spec), x), y)


@torch.no_grad()
def evaluate_stacked_flat(buf: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor, *, spec: FS.FlatSpec, shd=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean local-model test accuracy and loss over the workers' rows.
    With ``shd`` the buffer is this rank's block: its real rows' sums are
    all-reduced and divided by the fleet's worker count."""
    if shd is not None:
        buf = buf[:shd.n_home_real]
    p = FS.unflatten(buf, spec)
    h = torch.relu(torch.matmul(x, p["w1"]) + p["b1"][:, None])
    h = torch.relu(torch.bmm(h, p["w2"]) + p["b2"][:, None])
    logits = torch.bmm(h, p["w3"]) + p["b3"][:, None]        # (N, n, C)
    acc, loss = _acc_loss(logits, y)
    if shd is None:
        return acc.mean(), loss.mean()
    sums = torch.stack([acc.sum(), loss.sum()])
    shd.psum(sums)
    return sums[0] / shd.n_rows, sums[1] / shd.n_rows


# --------------------------------------------------------------------------- #
# Eq. 4: mixing
# --------------------------------------------------------------------------- #


def _mix_rows(buf: torch.Tensor, w_rows: torch.Tensor, col_ids,
              kernels: Optional[KernelConfig], shd=None,
              seg=None) -> torch.Tensor:
    """The Eq. 4 contraction of the k gathered rows: (k, N) @ (N, P), or the
    column-sparse (k, u) @ buf[col_ids] when ``col_ids`` is given — one
    ``kernels.aggregate`` call either way.  With ``shd`` (a
    ``sharding.rules.FleetSharding``; ``buf`` is this rank's block) it runs
    the mesh twin and returns only the rows of this rank's segment ``seg``
    of the gathered set."""
    p_blk = (kernels or KernelConfig()).agg_p_blk
    if shd is not None:
        if col_ids is not None:
            return AGG.aggregate_rows_cols_sharded(w_rows, col_ids, buf, shd,
                                                   seg, p_blk=p_blk)
        return AGG.aggregate_rows_sharded(w_rows, buf, shd, seg, p_blk=p_blk)
    return AGG.aggregate(w_rows, buf, col_ids, p_blk=p_blk)


def _scatter_mixed(buf: torch.Tensor, row_ids: torch.Tensor, rows,
                   shd, seg) -> torch.Tensor:
    """Write the mixed rows back in place: all k rows, or with ``shd`` this
    rank's segment of them into its own block."""
    if shd is None:
        return buf.index_copy_(0, row_ids.long(), rows)
    if seg[1] > seg[0]:
        buf.index_copy_(0, shd.local(row_ids[seg[0]:seg[1]]), rows)
    return buf


def mix_flat(buf: torch.Tensor, w_rows: torch.Tensor, row_ids: torch.Tensor,
             kernels: Optional[KernelConfig] = None, shd=None,
             seg=None) -> torch.Tensor:
    """Row-sparse Eq. 4 over the flat buffer, in place: mix the k
    non-identity rows only (every other row of W is identity).  With
    ``shd`` the buffer is this rank's block, ``w_rows`` has zero columns
    for the padding rows (``pad_w_cols``), and the rank writes back its
    segment ``seg`` of ``row_ids``."""
    if w_rows.shape[0] == 0:
        return buf
    return _scatter_mixed(buf, row_ids,
                          _mix_rows(buf, w_rows, None, kernels, shd, seg),
                          shd, seg)


def mix_flat_cols(buf: torch.Tensor, w_sub: torch.Tensor,
                  row_ids: torch.Tensor, col_ids: torch.Tensor,
                  kernels: Optional[KernelConfig] = None, shd=None,
                  seg=None) -> torch.Tensor:
    """Column-sparse Eq. 4 over the flat buffer, in place (the default mix
    path): ``w_sub`` (k, u) are the non-identity rows of W restricted to the
    union of their nonzero columns ``col_ids`` (u,); padding columns of
    ``w_sub`` are zero, so the product is exact.  ``shd``/``seg`` as in
    ``mix_flat``."""
    if w_sub.shape[0] == 0:
        return buf
    return _scatter_mixed(buf, row_ids,
                          _mix_rows(buf, w_sub, col_ids, kernels, shd, seg),
                          shd, seg)


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
    stacked ``(H, ·)`` horizon of them, sliced along the last axis), a
    tensor or the host's numpy array: ``(mix_ids, col_ids | None,
    train_ids, train_mask)`` with the mask as f32."""
    k_train = (ctrl.shape[-1] - k_mix - u) // 2
    mix_ids = ctrl[..., :k_mix]
    col_ids = ctrl[..., k_mix:k_mix + u] if u else None
    train_ids = ctrl[..., k_mix + u:k_mix + u + k_train]
    train_mask = ctrl[..., k_mix + u + k_train:]
    train_mask = (train_mask.astype(np.float32)
                  if isinstance(train_mask, np.ndarray)
                  else train_mask.to(torch.float32))
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
                    with_losses: bool = True, mix_is_train: bool = False,
                    shd=None, seg=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix + masked SGD of one round on pre-drawn batches, in place on
    ``buf``.  ``col_ids`` non-None selects the column-sparse contraction;
    ``fused_sgd`` the fused SGD kernel (else the autograd oracle).

    ``mix_is_train`` (host-verified: the mix row ids EQUAL the train row
    ids, as in every DySTop round) feeds the Eq. 4 output straight into
    Eq. 5, skipping the write-back and re-gather of the same rows.  Returns
    (buf, per-row mean losses (buf rows,), zero for idle rows).

    ``shd`` (a ``sharding.rules.FleetSharding``) runs this rank's share of
    the round: ``buf`` is its block, ``seg`` its ``(mix_lo, mix_hi,
    train_lo, train_hi)`` segments of the gathered ids (``shard_segments``),
    ``xb``/``yb`` the minibatches of its train segment only; it mixes and
    trains the rows of its block (the mix's all-reduce is the round's one
    collective) and the losses index its block."""
    n = buf.shape[0]
    k_train = train_row_ids.shape[0]
    mseg = tseg = None
    if shd is not None:
        mseg, tseg = (seg[0], seg[1]), (seg[2], seg[3])
        train_row_ids = train_row_ids[tseg[0]:tseg[1]]
        train_mask = train_mask[tseg[0]:tseg[1]]

    def train_rows(sub):
        if fused_sgd:
            sgd = FSGD.fused_sgd if shd is None else FSGD.fused_sgd_sharded
            return sgd(sub, xb, yb, train_mask, spec, lr,
                       with_losses=with_losses)
        return local_sgd_flat(sub, xb, yb, train_mask, spec, lr)

    losses = torch.zeros((n,), dtype=torch.float32, device=buf.device)
    tids = (train_row_ids.long() if shd is None
            else shd.local(train_row_ids))
    if fused_sgd and mix_is_train and k_train > 0 and w_rows.shape[0] > 0:
        sub = _mix_rows(buf, w_rows, col_ids, kernels, shd, mseg)
        if tids.shape[0] == 0:
            return buf, losses
        new_sub, sub_loss = train_rows(sub)
    else:
        if col_ids is not None:
            mix_flat_cols(buf, w_rows, mix_row_ids, col_ids, kernels, shd,
                          mseg)
        else:
            mix_flat(buf, w_rows, mix_row_ids, kernels, shd, mseg)
        if tids.shape[0] == 0:
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
               with_losses: bool = True, mix_is_train: bool = False,
               shd=None, seg=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One simulated round on the device: sparse mix + local SGD, in place.

    ``w_rows`` are the (k, N) non-identity rows of W, or with ``col_sparse``
    the (k, u) rows restricted to the column union; ``ctrl`` is the
    ``pack_round_ctrl`` vector; ``xb`` (k_train, steps, batch, dim) / ``yb``
    the train rows' minibatches (None when no row trains).  ``shd``/``seg``
    run this rank's share (``_mix_train_body``).  Returns (buf, per-row
    mean loss, zero for idle rows)."""
    k_mix = w_rows.shape[0]
    u = w_rows.shape[1] if col_sparse and k_mix else 0
    mix_ids, col_ids, train_ids, mask = split_ctrl(ctrl, k_mix, u)
    return _mix_train_body(buf, w_rows, mix_ids, col_ids, train_ids, mask,
                           xb, yb, spec, lr, kernels, fused_sgd, with_losses,
                           mix_is_train, shd, seg)


def mega_round_step(buf: torch.Tensor, w_rows: torch.Tensor,
                    ctrl: torch.Tensor, xb, yb, *, spec: FS.FlatSpec,
                    lr: float, kernels: Optional[KernelConfig] = None,
                    col_sparse: bool = False, fused_sgd: bool = False,
                    with_losses: bool = True, mix_is_train: bool = False,
                    shd=None, segs: Optional[np.ndarray] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H horizon-planned rounds back to back, in place on ``buf``.

    Inputs are the ``pack_horizon``/``pack_chunk`` stacks — ``w_rows
    (H, K_mix, N | U)``, ``ctrl (H, ·)`` — and the chunk's minibatches
    ``xb (H, K_train, steps, batch, dim)``/``yb`` (None when no row trains).
    With ``shd`` (this rank's share; ``segs`` the (H, 4) ``shard_segments``)
    the minibatches are those of the rank's train segments, round after
    round: ``(sum of segment lengths, steps, batch, dim)``.  Returns (buf,
    (H, buf rows) per-round losses)."""
    losses = []
    off = 0
    for h in range(w_rows.shape[0]):
        xh = yh = None
        if xb is not None:
            if shd is None:
                xh, yh = xb[h], yb[h]
            else:
                end = off + int(segs[h, 3] - segs[h, 2])
                xh, yh, off = xb[off:end], yb[off:end], end
        buf, loss = round_step(
            buf, w_rows[h], ctrl[h], xh, yh, spec=spec, lr=lr,
            kernels=kernels, col_sparse=col_sparse, fused_sgd=fused_sgd,
            with_losses=with_losses, mix_is_train=mix_is_train, shd=shd,
            seg=None if segs is None else segs[h])
        losses.append(loss)
    return buf, torch.stack(losses)


def shard_segments(ctrl: np.ndarray, k_mix: int, u: int, shd) -> np.ndarray:
    """(H, 4) ``[mix_lo, mix_hi, train_lo, train_hi]`` per round: this
    rank's segments of the packed mix and train ids (``shd.for_rows``; the
    packers sort ids by home shard when ``shards > 1``)."""
    mix_ids, _, train_ids, _ = split_ctrl(ctrl, k_mix, u)
    segs = np.zeros((ctrl.shape[0], 4), np.int64)
    for h in range(ctrl.shape[0]):
        if k_mix:
            segs[h, :2] = shd.for_rows(mix_ids[h])
        if train_ids.shape[-1]:
            segs[h, 2:] = shd.for_rows(train_ids[h])
    return segs


def pad_w_cols(w: np.ndarray, n_pad: int) -> np.ndarray:
    """Zero-pad the trailing (N) axis of a row-sparse W stack to the sharded
    buffer's padded row count: the extra columns multiply the permanently
    idle padding rows by 0, so the contraction value is unchanged (summing
    exact +0.0 terms) while shapes line up with the (N_pad, P) buffer."""
    if w.shape[-1] >= n_pad:
        return w
    pad = [(0, 0)] * (w.ndim - 1) + [(0, n_pad - w.shape[-1])]
    return np.pad(w, pad)

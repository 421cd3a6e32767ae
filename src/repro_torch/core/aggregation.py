"""Model aggregation (paper Eq. 4): the host-side numpy half.

Eq. 4 for every activated worker is one row-stochastic mixing matrix applied
to the flat (N, P) model buffer:

    W[i, :] = sigma_t^{i, .}   if i activated (data-size weights over pulled
                                 in-neighbors + self)
    W[i, :] = e_i              otherwise

Rows for non-activated workers are identity (they keep their model), so the
fused round engine only computes the k non-identity rows: ``mixing_rows``
gathers them (padded to a small set of power-of-two shape buckets) and the
``kernels.aggregate`` kernel does the (k, N) @ (N, P) skinny product, written
back into the flat buffer.

Column sparsity (the default engine path): each mixing row also has at most
max_neighbors+1 nonzero COLUMNS, so the k rows jointly touch only the union
of their nonzero columns — ``mixing_rows_cols`` restricts the gathered rows
to that u-column union (``col_union_mask``), cutting the contraction to
(k, u) @ (u, P) with u <= k*(max_neighbors+1).

``apply_mixing`` is the legacy per-leaf path (``SimConfig(fused_engine=
False)``): the dense (N, N) W applied to every leaf of a stacked model, one
``kernels.aggregate`` call per leaf — a second code path beside the flat
engine, kept as its oracle.
"""
from __future__ import annotations

import warnings
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import aggregate as AGG
from repro_torch.kernels.config import KernelConfig
from repro_torch.tree import tree_leaves, tree_map


def mixing_matrix_rows(active: np.ndarray, links: np.ndarray,
                       data_sizes: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Row-stochastic W (N, N) float32 per Eq. 4, plus its non-identity rows.

    links[i, j] = 1 iff worker i mixes in j's model this round (DySTop: only
    activated workers pull; SA-ADFL-style push baselines also set rows of the
    receiving neighbors).  The in-neighbor set includes i itself; weights are
    relative data sizes sigma_t^{i,j} = D_j / sum_{j' in N_i} D_j'.

    Vectorized: membership is links | I, weights are a masked broadcast of the
    data sizes normalized per row — no Python row loop.  Returns ``(W, rows)``
    where ``rows`` are the sorted indices of the non-identity rows
    (``active | links.any(1)``) — already resolved here, so the planner can
    carry them on the ``PlannedRound`` and the horizon packer never re-derives
    the mask.
    """
    active = np.asarray(active, bool)
    links = np.asarray(links, bool)
    n = len(active)
    mixing_rows_mask = active | links.any(axis=1)
    rows = np.flatnonzero(mixing_rows_mask)
    # only the k non-identity rows carry Eq. 4 weights; identity rows are
    # emitted directly, so the normalization runs on (k, N) instead of (N, N)
    # — bitwise-identical values row-by-row (per-round hot path)
    W = np.eye(n, dtype=np.float32)
    if len(rows):
        d = np.asarray(data_sizes, np.float64)
        members = links[rows]
        members[np.arange(len(rows)), rows] = True  # in-neighbors + self
        Wd = np.where(members, d[None, :], 0.0)
        Wd /= Wd.sum(axis=1, keepdims=True)
        W[rows] = Wd.astype(np.float32)
    return W, rows


def mixing_matrix(active: np.ndarray, links: np.ndarray,
                  data_sizes: np.ndarray) -> np.ndarray:
    """Row-stochastic W (N, N) float32 per Eq. 4 (see
    ``mixing_matrix_rows``, which also returns the non-identity row ids)."""
    return mixing_matrix_rows(active, links, data_sizes)[0]


def bucket_size(k: int, n: int, min_bucket: int = 8) -> int:
    """Power-of-two shape bucket for k gathered rows (clamped to N; 0 -> 0).

    Bucketing bounds the engine at O(log N) distinct launch shapes instead of
    one per distinct active count; the horizon packer takes the max bucket
    across its rounds, which is again a bucket, so mega-rounds inherit the
    same bound.
    """
    if k <= 0:
        return 0
    return min(n, max(min_bucket, 1 << (k - 1).bit_length()))


def plan_buckets(active: np.ndarray, links: np.ndarray,
                 min_bucket: int = 8) -> Tuple[int, int]:
    """(k_mix, k_train) shape buckets for one round's control masks.

    The single source of truth shared by the simulator's chunk splitter, the
    horizon packer, and the benchmarks: mix rows are the non-identity rows of
    W (``active | links.any(1)``), train rows the activated workers.
    """
    active = np.asarray(active, bool)
    links = np.asarray(links, bool)
    n = len(active)
    return (bucket_size(int((active | links.any(axis=1)).sum()), n, min_bucket),
            bucket_size(int(active.sum()), n, min_bucket))


def shard_pad_candidates(mask: np.ndarray, shards: int = 1) -> np.ndarray:
    """Idle rows eligible as bucket-padding targets, one per mesh shard.

    ``shards == 1`` (the unsharded engine) keeps the historical choice — the
    globally-first idle row — so padding is bit-identical to the pre-mesh
    code.  With a sharded ``(N_pad, P)`` buffer the padding gather/scatter is
    a cross-shard collective whenever the padding row lives off-shard, so the
    sharded engine instead offers the first idle row of EACH contiguous
    device block (GSPMD block size ``N_pad // shards``), falling back to the
    globally-first idle row for blocks with no idle member.  Returns the
    sorted unique candidate ids (empty iff no row is idle); ``padded_rows``
    cycles padding slots through them and ``col_union_mask`` admits all of
    their columns, keeping the two ends of the identity-row-padding contract
    consistent.
    """
    mask = np.asarray(mask, bool)
    idle = np.flatnonzero(~mask)
    if len(idle) == 0 or shards <= 1:
        return idle[:1]
    n = len(mask)
    block = (n + (-n) % shards) // shards
    first = idle[0]
    homes = idle // block
    picks = [idle[homes == s][0] if (homes == s).any() else first
             for s in range(shards)]
    return np.unique(np.asarray(picks))


def col_union_mask(active: np.ndarray, links: np.ndarray,
                   shards: int = 1) -> np.ndarray:
    """(N,) bool: the union of nonzero mixing-matrix COLUMNS this round.

    Row i of W (Eq. 4) is nonzero exactly on {i} ∪ {j : links[i, j]} when i
    mixes (``active[i] | links[i].any()``) and on {i} otherwise.  The union
    over the non-identity rows is therefore ``mix_mask | links.any(0)``
    (sources pulled from need not be mix rows themselves).  Whenever an idle
    worker exists, the padding-candidate idle indices
    (``shard_pad_candidates`` — the first idle row, or one per mesh shard
    when ``shards > 1``) are ALSO included so that row-bucket padding — which
    replicates those workers' identity rows — stays exact under the column
    restriction (e_idle restricted to the union must still pick out
    X[idle]).  Model-value-independent, so the planner can resolve it
    arbitrarily far ahead of the device.
    """
    active = np.asarray(active, bool)
    links = np.asarray(links, bool)
    mix_mask = active | links.any(axis=1)
    cols = mix_mask | links.any(axis=0)
    if mix_mask.any() and not mix_mask.all():
        cols = cols.copy()
        cols[shard_pad_candidates(mix_mask, shards)] = True
    return cols


def plan_buckets_cols(active: np.ndarray, links: np.ndarray,
                      min_bucket: int = 8) -> Tuple[int, int, int]:
    """(k_mix, k_train, u_cols) shape buckets for the column-sparse engine.

    Extends ``plan_buckets`` with the power-of-two bucket of the mixing
    column union (``col_union_mask``); the simulator's chunk splitter keys on
    the full triple so every round of a mega-round chunk shares one
    (k_mix, u) contraction shape.
    """
    k_mix, k_train = plan_buckets(active, links, min_bucket)
    n = len(np.asarray(active, bool))
    u = bucket_size(int(col_union_mask(active, links).sum()), n, min_bucket)
    return (k_mix, k_train, u)


# column-path gather/slab traffic per union column, in units of one dense
# buffer-row read: the (u, P) slab is read once by the gather, written once,
# and read once by the gemm.  The constant is the JAX reference's, kept so
# both packages pick the same contraction for the same round; it has not been
# re-measured for the CUDA kernel, which fuses the gather into its loads.
COL_GATHER_COST = 3.0


def prefer_cols(k: int, u: int, n: int,
                gather_cost: float = COL_GATHER_COST) -> bool:
    """Per-chunk traffic model: is the column-sparse contraction cheaper?

    Row-sparse Eq. 4 costs ``k·N·P`` gemm work; the column path costs
    ``k·u·P`` gemm work plus ``gather_cost·u·P`` slab traffic (gather read +
    slab write + gemm read).  Pick columns iff

        (k + gather_cost) · u  <  k · N

    evaluated on the BUCKETED shapes actually dispatched.  This subsumes the
    old binary ``u == N`` fallback (at u = N the inequality is always false)
    and additionally routes small-k chunks — where the slab traffic can't be
    amortized over enough rows — to the dense row read.  Both paths are
    value-exact, so the choice never perturbs trajectories (see
    ``COL_GATHER_COST`` for where the constant comes from).
    """
    if k <= 0 or u <= 0 or u >= n:
        return False
    return (k + gather_cost) * u < k * n


def padded_rows(mask: np.ndarray, min_bucket: int = 8,
                pad_to: int | None = None,
                shards: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Indices of the k True rows, padded to a power-of-two shape bucket.

    Returns ``(row_ids (k_pad,) i32, valid (k_pad,) bool)``.  Padding repeats
    a False row's index (with valid=False) so per-row work gathered by
    ``row_ids`` is a no-op there and the scatter-back rewrites that row's own
    value (duplicate scatter indices all carry the identical value).  Bucketing
    to powers of two (clamped to N) bounds the engine at O(log N) launch
    shapes instead of one per distinct active count.

    ``pad_to`` overrides the bucket (horizon packing: every round of a
    mega-round chunk must share one shape); it must be a bucket ≥ k, and a
    k = 0 round pads with index-0 no-op rows (all-idle ⇒ row 0 is idle).

    ``shards > 1`` (mesh-sharded buffer): padding slots cycle through one
    idle row per device block (``shard_pad_candidates``) and the id vector is
    returned SORTED, so gathered rows are grouped by home shard and the
    padded scatter-backs stay shard-local.  Row order is value-irrelevant —
    batch streams are keyed by worker id, not gather position, and scatters
    address rows by id — so ``shards`` never perturbs trajectories; with
    ``shards == 1`` the historical layout (first idle repeated, appended
    last) is preserved bit-for-bit.
    """
    mask = np.asarray(mask, bool)
    n = len(mask)
    rows = np.flatnonzero(mask)
    k = len(rows)
    k_pad = bucket_size(k, n, min_bucket) if pad_to is None else int(pad_to)
    if k_pad == 0:
        return np.zeros((0,), np.int32), np.zeros((0,), bool)
    if k_pad > k:
        cand = shard_pad_candidates(mask, shards)
        rows = np.concatenate(
            [rows, cand[np.arange(k_pad - k) % len(cand)]]).astype(rows.dtype)
        if shards > 1:
            rows = np.sort(rows)      # group by home shard (contiguous blocks)
    return rows.astype(np.int32), mask[rows]


def mixing_rows(W: np.ndarray, active: np.ndarray, links: np.ndarray,
                min_bucket: int = 8, pad_to: int | None = None,
                shards: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Gather the non-identity rows of W for the sparse aggregation path.

    Returns ``(W_rows (k_pad, N) f32, row_ids (k_pad,) i32)`` bucketed by
    ``padded_rows`` (``shards`` selects its shard-local padding layout);
    padding entries replicate an identity row of W targeting an idle worker,
    so the scatter-back is a no-op there.
    """
    active = np.asarray(active, bool)
    links = np.asarray(links, bool)
    row_ids, _ = padded_rows(active | links.any(axis=1), min_bucket, pad_to,
                             shards)
    return (np.ascontiguousarray(W[row_ids], np.float32) if len(row_ids)
            else np.zeros((0, len(active)), np.float32)), row_ids


def mixing_rows_cols(W: np.ndarray, active: np.ndarray, links: np.ndarray,
                     min_bucket: int = 8, pad_to: int | None = None,
                     col_pad_to: int | None = None,
                     cols_mask: np.ndarray | None = None,
                     shards: int = 1
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gather the non-identity rows of W restricted to their column union.

    The column-sparse companion of ``mixing_rows``: returns ``(W_sub
    (k_pad, u_pad) f32, row_ids (k_pad,) i32, col_ids (u_pad,) i32)`` where
    ``col_ids`` is the ``col_union_mask`` union bucketed by ``bucket_size``
    (``col_pad_to`` overrides, for horizon packing; ``cols_mask`` passes a
    precomputed union — e.g. ``PlannedRound.mix_cols``, resolved by the
    horizon planner ahead of dispatch).  Column padding repeats
    index 0 but the matching W_sub columns are ZEROED, so padded columns
    contribute exactly 0 to the contraction; row padding replicates an idle
    worker's identity row exactly as in ``mixing_rows`` (its column is a
    member of the union by construction — with ``shards > 1`` the union and
    the padding layout must be resolved with the SAME shard count, so the
    per-shard padding candidates' columns are all members).  When the union
    bucket reaches N the gather degenerates to ``col_ids = arange(N)`` — the
    row-sparse contraction with an extra no-op gather.
    """
    active = np.asarray(active, bool)
    links = np.asarray(links, bool)
    n = len(active)
    row_ids, _ = padded_rows(active | links.any(axis=1), min_bucket, pad_to,
                             shards)
    if len(row_ids) == 0:
        return (np.zeros((0, 0), np.float32), row_ids,
                np.zeros((0,), np.int32))
    if cols_mask is None:
        cols_mask = col_union_mask(active, links, shards)
    cols = np.flatnonzero(cols_mask)
    u = len(cols)
    u_pad = bucket_size(u, n, min_bucket) if col_pad_to is None \
        else int(col_pad_to)
    if u_pad >= n:
        u_pad = n
        col_ids = np.arange(n, dtype=np.int32)
        u = n
    else:
        col_ids = np.concatenate(
            [cols, np.zeros(u_pad - u, cols.dtype)]).astype(np.int32)
    W_sub = np.ascontiguousarray(W[np.ix_(row_ids, col_ids)], np.float32)
    W_sub[:, u:] = 0.0                     # padded columns contribute nothing
    return W_sub, row_ids, col_ids


def apply_mixing(W, stacked_models: Any, kernels: Any = None,
                 use_kernel: Optional[bool] = None) -> Any:
    """``new_models = W @ models``, per leaf (the port of
    ``repro.core.aggregation.apply_mixing``).  Leaves: (N, ...).

    Each leaf is flattened to (N, P_leaf), cast to f32, mixed by the dense
    (N, N) ``W`` through ``kernels.aggregate`` (``col_ids=None``: the CUDA
    kernel on a CUDA leaf, ``aggregate_plain`` on a CPU one) and cast back
    to the leaf's dtype.  ``kernels`` is a ``kernels.config.KernelConfig``
    (None: the default tiles); ``use_kernel`` is the JAX package's
    deprecated boolean: the tensor's device picks the kernel here, so it
    warns and changes nothing."""
    if use_kernel is not None:
        warnings.warn(
            "apply_mixing(use_kernel=...) is deprecated and changes nothing: "
            "the tensor's device picks the kernel", DeprecationWarning,
            stacklevel=2)
    p_blk = (kernels if kernels is not None else KernelConfig()).agg_p_blk
    dev = tree_leaves(stacked_models)[0].device
    w = torch.as_tensor(W, dtype=torch.float32).to(dev).contiguous()

    def mix(leaf: torch.Tensor) -> torch.Tensor:
        flat = leaf.reshape(leaf.shape[0], -1).to(torch.float32).contiguous()
        out = AGG.aggregate(w, flat, p_blk=p_blk)
        return out.reshape(leaf.shape).to(leaf.dtype)

    return tree_map(mix, stacked_models)

"""DFL over the model zoo: a device-resident, planner-driven LM fleet.

The port of ``repro.dfl.lm_worker`` on its resident, pipelined path:

  * ``LMFleet`` holds all N replicas' params AND optimizer state as two
    resident flat buffers, ``(N, P)`` / ``(N, S)`` f32 (ravel metadata in a
    ``flat_state.FleetSpec``), built once at init and updated in place.
  * ``core.planner.HorizonPlanner`` drives the control plane; bucket-uniform
    chunks of ``PlannedRound``s (``core.planner.chunk_spans``) go to the card
    as one ``LMEngine.dispatch_chunk`` each, with row- or column-sparse
    Eq. 4 mixing (``kernels.aggregate``) picked per chunk by
    ``aggregation.prefer_cols``, and the ``mix_is_train`` fusion feeding the
    Eq. 4 output straight into the train step.
  * local training gathers only the k activated rows: each takes one
    optimizer step through the model (attention in ``kernels.
    flash_attention``, mamba2's intra-chunk SSD in ``kernels.ssd_chunk``)
    in a loop over the rows — the JAX package vmaps them inside one
    ``lax.scan`` — and writes its params and state back in place.

Everything runs on ``device`` ("cuda" unless the caller asks for "cpu",
where the kernels' plain versions run); the control plane and the token
streams run on the host with the JAX package's numpy draws, so both
packages see identical control trajectories and batches.  With
``mesh_shards > 1`` the resident buffers are row-partitioned over a fleet
mesh of that many processes (``launch.mesh``,
``sharding.rules.FleetSharding``).  ``checkpoint_every`` writes atomic
snapshots of the whole fleet (``checkpoint.io``, the JAX package's layout)
that ``resume_from`` continues exactly and ``serving.bridge`` serves.

``LMRunConfig(resident_fleet=False)`` runs the JAX package's per-call-flatten
oracle instead: the fleet's stacked pytrees are materialized once, each
round re-flattens them for Eq. 4 (``fleet_mix_stacked``) and trains ALL N
workers, masking the inactive updates away (``make_fleet_step``), and the
pytrees are written back once at the end.  The vlm and enc-dec
families are refused at set-up (``check_trainable``): their row-step would
need stub prefix embeddings or frames that the JAX package's fleet does not
feed either.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import (Any, Callable, ClassVar, Dict, Iterator, List, Optional,
                    Tuple)

import numpy as np
import torch

from repro_torch.checkpoint import io as CIO
from repro_torch.configs.base import ModelConfig
from repro_torch.core.aggregation import mixing_rows, prefer_cols
from repro_torch.core.planner import (HorizonPlanner, PlannedRound,
                                      bucket_key, chunk_spans, mix_is_train)
from repro_torch.core.scenarios import resolve_scenario
from repro_torch.data.synthetic import make_token_stream
from repro_torch.device import resolve_device
from repro_torch.dfl import flat_state as FS
from repro_torch.dfl import worker as WK
from repro_torch.dfl.network import (EdgeNetwork, NetworkConfig,
                                     heterogeneous_compute_times)
from repro_torch.dfl.pipeline import DispatchPipeline
from repro_torch.kernels import aggregate as AGG
from repro_torch.kernels.config import KernelConfig
from repro_torch.launch import mesh as MESH
from repro_torch.models import registry as R
from repro_torch.optim import Optimizer, get_optimizer
from repro_torch.sharding.rules import FleetSharding
from repro_torch.tree import (tree_from_paths, tree_leaves, tree_map,
                              tree_paths)

F32 = torch.float32


@dataclasses.dataclass
class LMFleet:
    """N worker replicas of one architecture, resident on one device.

    ``pbuf`` (N, P) and ``obuf`` (N, S) are the only storage; ``spec``
    carries the ravel metadata of both.  The ``stacked_*`` properties
    materialize the stacked trees (f32 storage holds the bf16 params and the
    int32 step counter exactly); assigning a stacked tree re-flattens it
    into the buffer, and the round trip is exact.  On a rank of a fleet
    mesh the buffers are the rank's ``(block, ·)`` block of the padded
    fleet while it trains (``init_fleet(shd=...)``)."""
    cfg: ModelConfig
    pbuf: torch.Tensor              # (N, P) f32 resident params
    obuf: torch.Tensor              # (N, S) f32 resident optimizer state
    spec: FS.FleetSpec
    optimizer: Optimizer
    n_workers: int

    @property
    def stacked_params(self):
        return FS.unflatten_tree(self.pbuf, self.spec.params)

    @stacked_params.setter
    def stacked_params(self, value) -> None:
        self.pbuf, pspec = FS.flatten_tree(value)
        self.spec = FS.FleetSpec(params=pspec, opt=self.spec.opt)

    @property
    def stacked_opt(self):
        return FS.unflatten_tree(self.obuf, self.spec.opt)

    @stacked_opt.setter
    def stacked_opt(self, value) -> None:
        self.obuf, ospec = FS.flatten_tree(value)
        self.spec = FS.FleetSpec(params=self.spec.params, opt=ospec)

    @property
    def model_bytes(self) -> int:
        """Bytes of one replica at its shipped dtypes (Eq. 10 pricing)."""
        return FS.nbytes_of(self.spec.params)

    @property
    def opt_bytes(self) -> int:
        return FS.nbytes_of(self.spec.opt)


def _fleet_spec(params, opt: Optimizer) -> Tuple[FS.FleetSpec, Any]:
    opt_state = opt.init(params)
    return FS.FleetSpec(params=FS.tree_spec(params),
                        opt=FS.tree_spec(opt_state)), opt_state


def init_fleet(cfg: ModelConfig, n_workers: int, optimizer: str = "adam",
               lr: float = 1e-3, seed: int = 0,
               device="cuda", shd: Optional[FleetSharding] = None
               ) -> LMFleet:
    """All workers start from one w_0 (paper Thm. 1's shared init): drawn
    on the CPU from ``torch.Generator().manual_seed(seed)``, so the card and
    the CPU start alike, then raveled once into the resident buffers.
    With ``shd`` the buffers are this rank's block (its real rows w_0, its
    padding rows zero): the same draw at every shard count."""
    opt = get_optimizer(optimizer, lr)
    params = R.init_params(cfg, torch.Generator().manual_seed(seed))
    params = tree_map(lambda leaf: leaf.to(device), params)
    spec, opt_state = _fleet_spec(params, opt)

    def rows(tree, fs):
        row = torch.empty((fs.n_params,), dtype=F32, device=device)
        FS.ravel_tree_into(tree, fs, row)
        if shd is None:
            return row.expand(n_workers, -1).clone()
        block = torch.zeros((shd.block, fs.n_params), dtype=F32,
                            device=device)
        block[:shd.n_home_real] = row
        return block

    return LMFleet(cfg=cfg, pbuf=rows(params, spec.params),
                   obuf=rows(opt_state, spec.opt), spec=spec, optimizer=opt,
                   n_workers=n_workers)


def worker_streams(cfg: ModelConfig, n_workers: int, batch: int, seq: int,
                   seed: int = 0, noniid_offset: bool = True,
                   skip_rounds: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Per-worker token batches, drawn exactly as the JAX package draws
    them (same stream, same ``rng.integers`` calls in the same order), so
    both packages train on bit-identical batches.  Non-IID-ness: each worker
    samples from a different slice of one long stream."""
    stream = make_token_stream(cfg.vocab_size, 400_000, seed=seed)
    n = len(stream) - seq - 1
    rng = np.random.default_rng(seed)
    slice_len = n // n_workers if noniid_offset else n
    # row s of the view is stream[s : s + seq + 1] — tokens + shifted labels
    windows = np.lib.stride_tricks.sliding_window_view(stream, seq + 1)

    def draw(w: int) -> np.ndarray:
        lo = w * slice_len % max(n - slice_len, 1) if noniid_offset else 0
        return rng.integers(lo, lo + max(slice_len - seq - 1, 1), size=batch)

    for _ in range(skip_rounds):
        for w in range(n_workers):
            draw(w)
    while True:
        starts = np.empty((n_workers, batch), np.int64)
        for w in range(n_workers):
            starts[w] = draw(w)
        win = windows[starts]                   # ONE gather: (W, B, seq + 1)
        yield {"tokens": np.ascontiguousarray(win[..., :-1]),
               "labels": np.ascontiguousarray(win[..., 1:]),
               "loss_mask": np.ones((n_workers, batch, seq), np.float32)}


def _batch(tokens: torch.Tensor, labels: torch.Tensor) -> Dict[str, Any]:
    return {"tokens": tokens, "labels": labels,
            "loss_mask": torch.ones(tokens.shape, dtype=F32,
                                    device=tokens.device)}


@torch.no_grad()
def _global_loss(cfg: ModelConfig, pspec: FS.FlatSpec, pbuf: torch.Tensor,
                 alpha: torch.Tensor, batch: Dict[str, Any],
                 shd: Optional[FleetSharding] = None) -> torch.Tensor:
    """Loss of the data-size-weighted global model (paper Eq. 11): one
    ``alpha @ pbuf`` product, an unravel and one forward.  With ``shd``
    ``pbuf`` and ``alpha`` are this rank's block and one all-reduce sums
    the partial products."""
    row = FS.weighted_row(pbuf, alpha)
    if shd is not None:
        shd.psum(row)
    return R.compute_loss(cfg, FS.unravel_tree(row, pspec), batch)[0]


def fleet_eval(fleet: LMFleet, batch: Dict[str, torch.Tensor],
               alpha: torch.Tensor) -> float:
    """Eq. 11 loss of ``fleet`` on ``batch`` (tokens, labels, loss_mask)."""
    return float(_global_loss(fleet.cfg, fleet.spec.params, fleet.pbuf,
                              alpha, batch))


# --------------------------------------------------------------------------- #
# the per-call-flatten oracle (LMRunConfig(resident_fleet=False))
# --------------------------------------------------------------------------- #


def _mix(buf: torch.Tensor, W, active, links, kernels) -> torch.Tensor:
    """Eq. 4 on a flat (N, P) buffer: with ``active``/``links`` only the k
    non-identity rows of W (``worker.mix_flat``, in place), else the dense
    (N, N) product — one ``kernels.aggregate`` launch either way."""
    kernels = kernels if kernels is not None else KernelConfig()
    dev = buf.device
    if active is not None and links is not None:
        w_rows, row_ids = mixing_rows(np.asarray(W, np.float32), active,
                                      links)
        return WK.mix_flat(buf, torch.from_numpy(w_rows).to(dev),
                           torch.from_numpy(row_ids).to(dev), kernels)
    w = torch.as_tensor(W, dtype=F32).to(dev).contiguous()
    return AGG.aggregate(w, buf, p_blk=kernels.agg_p_blk)


def fleet_mix_stacked(stacked_params, W, active: Optional[np.ndarray] = None,
                      links: Optional[np.ndarray] = None,
                      kernels: Optional[KernelConfig] = None):
    """Eq. 4 over a stacked param tree, re-flattening per call: flatten the
    fleet, mix (``_mix``), unflatten to the tree the masked train step
    consumes."""
    buf, spec = FS.flatten_tree(stacked_params)
    return FS.unflatten_tree(_mix(buf, W, active, links, kernels), spec)


def fleet_mix(fleet: LMFleet, W, active: Optional[np.ndarray] = None,
              links: Optional[np.ndarray] = None,
              kernels: Optional[KernelConfig] = None) -> None:
    """Eq. 4 over the resident ``fleet.pbuf`` (``_mix``): no flatten, no
    pytree."""
    fleet.pbuf = _mix(fleet.pbuf, W, active, links, kernels)


def make_fleet_step(fleet: LMFleet) -> Callable:
    """The oracle's train step over stacked trees: ``step(stacked_params,
    stacked_opt, batch, active) -> (stacked_params, stacked_opt, losses
    (N,))``.  It trains ALL N workers, one after another (the JAX package
    vmaps them), and masks the inactive updates away with the reference's
    ``n * a + o * (1 - a)``, ``a`` in {0, 1} cast to each leaf's dtype (bit
    for bit ``n`` or ``o``); each worker's new row is written into the
    stacked trees in place."""
    cfg, opt = fleet.cfg, fleet.optimizer

    def masked(new_tree, old_tree, stacked, i: int, a: torch.Tensor):
        for (_, nw), (_, od), (_, st) in zip(tree_paths(new_tree),
                                             tree_paths(old_tree),
                                             tree_paths(stacked)):
            am = a.to(nw.dtype)
            st[i] = nw * am + od * (1 - am)

    def step(sp, so, batch: Dict[str, torch.Tensor], active):
        active = np.asarray(active.cpu() if torch.is_tensor(active)
                            else active)
        losses = torch.zeros((len(active),), dtype=F32,
                             device=tree_leaves(sp)[0].device)
        for i in range(len(active)):
            params = tree_map(lambda leaf: leaf[i].detach().requires_grad_(),
                              sp)
            paths = [path for path, _ in tree_paths(params)]
            with torch.enable_grad():
                loss, _ = R.compute_loss(cfg, params,
                                         {k: v[i] for k, v in batch.items()})
                grads = torch.autograd.grad(loss, tree_leaves(params))
            with torch.no_grad():
                state = tree_map(lambda leaf: leaf[i], so)
                old = tree_map(torch.Tensor.detach, params)
                new_p, new_s = opt.update(tree_from_paths(zip(paths, grads)),
                                          state, old)
                a = torch.tensor(float(active[i]), dtype=F32)
                masked(new_p, old, sp, i, a)
                masked(new_s, state, so, i, a)
            losses[i] = loss.detach()
        return sp, so, losses

    return step


@torch.no_grad()
def fleet_eval_stacked(cfg: ModelConfig, stacked_params,
                       batch: Dict[str, torch.Tensor],
                       alpha: torch.Tensor) -> float:
    """Eq. 11 eval through the stacked tree: the global model leaf by leaf
    (``tensordot(alpha, leaf, 1)`` in f32, cast to the leaf's dtype)."""
    gm = tree_map(lambda leaf: torch.tensordot(
        alpha, leaf.to(F32), dims=1).to(leaf.dtype), stacked_params)
    return float(R.compute_loss(cfg, gm, batch)[0])


# --------------------------------------------------------------------------- #
# the resident engine: gathered-active-row rounds
# --------------------------------------------------------------------------- #


class LMEngine:
    """Round dispatch for one fleet's (cfg, optimizer, spec).

    ``dispatch_chunk`` runs a bucket-uniform chunk of ``PlannedRound``s in
    place on the resident buffers: per round, Eq. 4 mixes the k
    non-identity rows (row- or column-sparse, ``worker.mix_flat`` /
    ``mix_flat_cols``, one ``kernels.aggregate`` launch), then each
    activated row takes one optimizer step through the model and is written
    back.  Inactive rows are never touched, and padding rows (mask 0) stay
    bit-identical.  Under the ``mix_is_train`` fusion (mix rows == train
    rows, every DySTop round) the mixed rows feed the train step directly.

    ``shd`` (a ``sharding.rules.FleetSharding``) runs this rank's share:
    the buffers are its blocks, the mix goes through the mesh twins of
    ``kernels.aggregate`` (one all-reduce per round), and the rank trains
    only the activated rows of its own block, flash attention included.
    """

    def __init__(self, cfg: ModelConfig, optimizer: Optimizer,
                 spec: FS.FleetSpec,
                 kernels: Optional[KernelConfig] = None,
                 shd: Optional[FleetSharding] = None):
        self.cfg, self.opt, self.spec = cfg, optimizer, spec
        self.kernels = kernels or KernelConfig()
        self.shd = shd

    def _train_row(self, pvec: torch.Tensor, ovec: torch.Tensor,
                   tok: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
        """One worker's step, in place on its param row ``pvec`` and state
        row ``ovec``; returns its loss (0-dim, on the device).  The new
        params come out of ``Optimizer.update`` already rounded to their
        dtypes, and widen exactly into the f32 row."""
        spec = self.spec
        params = FS.unravel_tree(pvec, spec.params, copy=True)
        leaves = [leaf.requires_grad_() for leaf in tree_leaves(params)]
        with torch.enable_grad():
            loss, _ = R.compute_loss(self.cfg, params, _batch(tok, lab))
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new_p, new_s = self.opt.update(
                tree_from_paths(zip(spec.params.keys, grads)),
                FS.unravel_tree(ovec, spec.opt),
                tree_map(torch.Tensor.detach, params))
            FS.ravel_tree_into(new_s, spec.opt, ovec)
            FS.ravel_tree_into(new_p, spec.params, pvec)
        return loss.detach()

    def _train_rows(self, prow: Callable[[int], torch.Tensor],
                    obuf: torch.Tensor, rows_h: np.ndarray,
                    mask_h: np.ndarray, tok: torch.Tensor,
                    lab: torch.Tensor) -> torch.Tensor:
        """Train the gathered rows whose mask is set (``prow(i)`` is gathered
        row i's param row, ``rows_h[i]`` its row of ``obuf``); returns the
        losses, 0 for padding rows."""
        losses = torch.zeros((len(rows_h),), dtype=F32, device=obuf.device)
        for i in np.flatnonzero(mask_h > 0):
            losses[i] = self._train_row(prow(i), obuf[int(rows_h[i])],
                                        tok[i], lab[i])
        return losses

    def _round_body(self, pbuf, obuf, w, mids, cids, tids, tids_h, mask_h,
                    tok, lab, fuse: bool, seg=None) -> torch.Tensor:
        """One round in place; returns the (rows,) losses.  With ``shd``,
        ``seg`` is this rank's ``shard_segments`` row, ``tok``/``lab``
        hold its train segment's batches, and the losses span the padded
        fleet (0 off this rank's block)."""
        shd = self.shd
        k_mix, k_train = w.shape[0], tids.shape[0]
        mseg = None
        rows_h = tids_h
        if shd is None:
            n = pbuf.shape[0]
            rows_d = tids.long()
        else:
            n = shd.n_pad
            mseg, (a, b) = (seg[0], seg[1]), (seg[2], seg[3])
            tids, tids_h, mask_h = tids[a:b], tids_h[a:b], mask_h[a:b]
            rows_h = tids_h - shd.home[0]
            rows_d = shd.local(tids)
        losses = torch.zeros((n,), dtype=F32, device=pbuf.device)
        tids_d = tids.long()
        if fuse and k_mix and k_train:
            # mix rows == train rows: Eq. 4 output feeds the step directly;
            # padding rows carry their identity-mixed (unchanged) value back
            sub = WK._mix_rows(pbuf, w, cids, self.kernels, shd, mseg)
            if len(rows_h) == 0:
                return losses
            sl = self._train_rows(lambda i: sub[i], obuf, rows_h, mask_h,
                                  tok, lab)
            pbuf.index_copy_(0, rows_d, sub)
            return losses.index_copy_(0, tids_d, sl)
        if k_mix:
            if cids is not None:
                WK.mix_flat_cols(pbuf, w, mids, cids, self.kernels, shd,
                                 mseg)
            else:
                WK.mix_flat(pbuf, w, mids, self.kernels, shd, mseg)
        if k_train and len(rows_h):
            sl = self._train_rows(lambda i: pbuf[int(rows_h[i])], obuf,
                                  rows_h, mask_h, tok, lab)
            losses.index_copy_(0, tids_d, sl)
        return losses

    def dispatch_chunk(self, pbuf, obuf, chunk: List[PlannedRound],
                       tokens: np.ndarray, labels: np.ndarray, *,
                       key: Tuple[int, ...], col_sparse: bool, fuse: bool,
                       min_bucket: int = 8, pregather: bool = False,
                       walls=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One bucket-uniform chunk, in place on ``pbuf``/``obuf``.

        ``tokens``/``labels`` are the full-N per-round batches (H, N, B, S).
        ``pregather=True`` gathers the k activated rows on the host (by the
        padded train ids packed into ``ctrl``; with ``shd``, only this
        rank's segment of them) so only those rows cross to the card;
        otherwise they are gathered on the device.  ``key`` is the chunk's
        ``bucket_key`` (``worker.pack_chunk`` packs by it); ``walls``
        accumulates ``pack_wall_s`` / ``stage_wall_s``.  Returns (pbuf,
        obuf, (H, rows) per-round losses — zero for idle workers; with
        ``shd`` the rows span the padded fleet and only this rank's are
        filled)."""
        shd = self.shd
        t0 = time.perf_counter()
        w, c, _ = WK.pack_chunk(chunk, key, min_bucket=min_bucket,
                                col_sparse=col_sparse,
                                shards=1 if shd is None else shd.n_shards)
        if shd is not None and not (col_sparse and w.shape[1]):
            w = WK.pad_w_cols(w, shd.n_pad)
        k_mix = w.shape[1]
        u = w.shape[2] if col_sparse and k_mix else 0
        # one ctrl-layout definition: the host and the device split alike
        _, _, tids_h, mask_h = WK.split_ctrl(c, k_mix, u)
        k_train = tids_h.shape[-1]
        segs = (np.tile([0, k_mix, 0, k_train], (len(chunk), 1))
                if shd is None else WK.shard_segments(c, k_mix, u, shd))
        pregather = pregather and bool(k_train)
        if pregather:
            own = [tids_h[h, a:b] for h, (a, b) in enumerate(segs[:, 2:])]
            tokens = np.concatenate([tokens[h, r] for h, r in enumerate(own)])
            labels = np.concatenate([labels[h, r] for h, r in enumerate(own)])
        t1 = time.perf_counter()
        dev = pbuf.device

        def stage(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a))
            return (t.pin_memory().to(dev, non_blocking=True)
                    if dev.type == "cuda" else t)

        w_d, c_d, tk_d, lb_d = (stage(a) for a in (w, c, tokens, labels))
        if walls is not None:
            walls.pack_wall_s += t1 - t0
            walls.stage_wall_s += time.perf_counter() - t1
        mix_ids, col_ids, train_ids, _ = WK.split_ctrl(c_d, k_mix, u)
        losses = []
        off = 0
        for h in range(len(chunk)):
            a, b = segs[h, 2], segs[h, 3]
            if pregather:        # this chunk's gathered rows, round by round
                tk, lb = tk_d[off:off + b - a], lb_d[off:off + b - a]
                off += b - a
            else:
                tk, lb = tk_d[h], lb_d[h]
                if k_train:
                    ids = train_ids[h, a:b].long()
                    tk, lb = tk[ids], lb[ids]
            losses.append(self._round_body(
                pbuf, obuf, w_d[h], mix_ids[h],
                None if col_ids is None else col_ids[h], train_ids[h],
                tids_h[h], mask_h[h], tk, lb, fuse,
                None if shd is None else segs[h]))
        return pbuf, obuf, torch.stack(losses)

    def eval_global(self, pbuf: torch.Tensor, alpha: torch.Tensor,
                    tokens: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
        """Eq. 11 eval of the resident buffer (0-dim loss on the device);
        with ``shd``, of the whole fleet from this rank's block and its
        ``alpha`` entries."""
        return _global_loss(self.cfg, self.spec.params, pbuf, alpha,
                            _batch(tokens, labels), self.shd)


# --------------------------------------------------------------------------- #
# planner-driven federation loop
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class LMRunConfig:
    """LM-plane run configuration (the JAX package's ``LMRunConfig``, plus
    ``device``).

    ``scan_horizon``: the planner resolves up to this many rounds ahead and
    the engine runs them as one chunk; ``pipeline_depth``: chunks in flight
    on the card while the host plans, packs and stages the next (0 is
    lockstep).  Histories are identical at any horizon and depth.
    ``min_bucket=2``: LM fleets are small, so fine shape buckets keep the
    gathered row set near the true activation count.
    ``host_batch_gather`` gathers the k activated batch rows on the host.
    ``mesh_shards > 1`` row-partitions the resident buffers over a fleet
    mesh of that many ranks (see ``run_lm_federation``).

    ``device``: where the model plane runs — ``"cuda"`` (the default; the
    run raises if there is no CUDA card) or ``"cpu"``.
    ``checkpoint_every > 0`` snapshots the fleet every that many rounds into
    ``checkpoint_dir``, keeping the ``checkpoint_keep`` newest (snapshot
    rounds are flush boundaries with the pipeline drained).  ``use_kernel``
    (the JAX package's deprecated alias) warns and changes nothing: the
    tensor's device picks the kernel.  ``resident_fleet=False`` runs the
    JAX package's per-call-flatten oracle (see the module docstring): one
    round per dispatch, so ``scan_horizon``, ``pipeline_depth``,
    ``col_sparse_mix``, ``host_batch_gather`` and ``min_bucket`` do not
    apply, and it takes no mesh (``mesh_shards > 1`` raises ``ValueError``
    when the run starts).
    """
    n_workers: int = 8
    n_rounds: int = 30
    batch: int = 4
    seq: int = 64
    optimizer: str = "adam"
    lr: float = 1e-3
    scan_horizon: int = 8
    pipeline_depth: int = 1
    resident_fleet: bool = True
    col_sparse_mix: bool = True
    mesh_shards: int = 1
    host_batch_gather: bool = True
    min_bucket: int = 2
    eval_every: int = 5
    seed: int = 0
    tau_bound: int = 4
    bandwidth_budget: float = 6.0
    link_timeout_s: float = 5.0
    sync_link_timeout_s: float = 30.0
    comm_range_m: float = 80.0
    compute_sigma: float = 0.6
    use_kernel: bool = False          # deprecated alias; changes nothing
    kernels: Optional[KernelConfig] = None  # kernel tiles; None =
                                      #   KernelConfig()
    failure_prob: float = 0.0         # stochastic edge dynamics
    failure_persist: float = 0.5
    scenario: Optional[object] = None # fault plane (core.scenarios): None,
                                      #   a preset name, or a ScenarioSchedule
    checkpoint_every: int = 0         # rounds between snapshots; 0 = off
    checkpoint_dir: Optional[str] = None
    checkpoint_keep: int = 3
    device: str = "cuda"              # where the model plane runs

    def __post_init__(self):
        for f in ("failure_prob", "failure_persist"):
            v = getattr(self, f)
            if not (0.0 <= v <= 1.0):
                raise ValueError(
                    f"LMRunConfig.{f} must be a probability in [0, 1], got "
                    f"{v} — out-of-range values silently degenerate the "
                    f"edge-dynamics mask to 'never' or 'always'")
        for f in ("link_timeout_s", "sync_link_timeout_s", "lr",
                  "bandwidth_budget", "comm_range_m"):
            v = getattr(self, f)
            if v <= 0:
                raise ValueError(f"LMRunConfig.{f} must be > 0, got {v}")
        for f in ("n_workers", "n_rounds", "batch", "seq", "eval_every",
                  "scan_horizon", "mesh_shards", "min_bucket"):
            v = getattr(self, f)
            if v < 1:
                raise ValueError(f"LMRunConfig.{f} must be >= 1, got {v}")
        if self.pipeline_depth < 0:
            raise ValueError(f"LMRunConfig.pipeline_depth must be >= 0 "
                             f"(0 = lockstep), got {self.pipeline_depth}")
        if self.checkpoint_every < 0:
            raise ValueError(f"LMRunConfig.checkpoint_every must be >= 0 "
                             f"(0 disables snapshots), got "
                             f"{self.checkpoint_every}")
        if self.checkpoint_every > 0 and not self.checkpoint_dir:
            raise ValueError(
                "LMRunConfig.checkpoint_every > 0 needs checkpoint_dir: "
                "pass the directory snapshots should land in")
        if self.kernels is not None and not isinstance(self.kernels,
                                                       KernelConfig):
            raise ValueError(
                f"LMRunConfig.kernels must be a kernels.config.KernelConfig "
                f"(or None for the default tiles), got "
                f"{type(self.kernels).__name__}")
        if self.kernels is None:
            self.kernels = KernelConfig()
        if str(self.device).split(":")[0] not in ("cpu", "cuda"):
            raise ValueError(f"LMRunConfig.device must be 'cuda' (the card) "
                             f"or 'cpu', got {self.device!r}")
        if self.use_kernel:
            warnings.warn(
                "LMRunConfig.use_kernel is deprecated and changes nothing: "
                "the tensor's device picks the kernel (CUDA tensors run the "
                "CUDA kernels, CPU tensors their plain versions)",
                DeprecationWarning, stacklevel=2)


@dataclasses.dataclass
class LMHistory:
    """Trajectory of one LM federation run (units as ``simulator.History``:
    sim_time in simulated seconds, comm in GB, staleness in rounds, the
    ``*_wall_s`` fields in real host seconds — ``plan`` in the planner,
    ``pack`` chunk splitting and packing, ``stage`` host-to-device staging,
    ``drain`` the host blocked on the device, ``eval`` the Eq. 11 evals,
    ``setup`` everything before the round loop; ``mesh_backend`` the fleet
    mesh's collective backend, None without a mesh)."""
    rounds: List[int] = dataclasses.field(default_factory=list)
    sim_time: List[float] = dataclasses.field(default_factory=list)
    comm_gb: List[float] = dataclasses.field(default_factory=list)
    loss_global: List[float] = dataclasses.field(default_factory=list)
    loss_local: List[float] = dataclasses.field(default_factory=list)
    staleness_avg: List[float] = dataclasses.field(default_factory=list)
    staleness_max: List[int] = dataclasses.field(default_factory=list)
    round_durations: List[float] = dataclasses.field(default_factory=list)
    round_active: List[int] = dataclasses.field(default_factory=list)
    round_loss: List[float] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    eval_wall_s: float = 0.0
    setup_wall_s: float = 0.0
    plan_wall_s: float = 0.0
    pack_wall_s: float = 0.0
    stage_wall_s: float = 0.0
    drain_wall_s: float = 0.0
    # a class attribute, not a field (the fields mirror the JAX package's);
    # a mesh run sets it on its history
    mesh_backend: ClassVar[Optional[str]] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family whose row-step would need a feed
    the fleet's token streams do not carry: the vlm family's stub prefix
    embeddings, the enc-dec family's stub audio frames.  The JAX package's
    row-step builds only tokens, labels and the loss mask, and fails on
    both families with ``KeyError`` at its first row-step."""
    feed = ("prefix_embeds" if R.has_prefix(cfg)
            else "frames" if R.is_encdec(cfg) else None)
    if feed is not None:
        raise ValueError(
            f"run_lm_federation: {cfg.arch_id} ({cfg.family} family) needs "
            f"batch[{feed!r}], which the fleet's row-step does not feed "
            f"(it builds tokens, labels and loss_mask, as the JAX package's "
            f"does); train it through models.registry.compute_loss with "
            f"your own {feed}")


def run_lm_federation(mechanism, cfg: ModelConfig, run: LMRunConfig,
                      resume_from: Optional[str] = None, *,
                      device: Optional[str] = None,
                      init: Optional[Tuple[np.ndarray, np.ndarray]] = None
                      ) -> Tuple[LMFleet, LMHistory]:
    """Federate N replicas of ``cfg`` under ``mechanism``, planner-driven.

    The ``HorizonPlanner`` owns all control state; one token-stream draw
    happens per planned round in plan order, so the batches, like the
    control trajectory, do not depend on ``scan_horizon`` or
    ``pipeline_depth``.  ``device`` overrides ``run.device``.

    ``resume_from``: a snapshot file or checkpoint directory (its newest
    snapshot) from a ``checkpoint_every`` run of the same config, by this
    port or the JAX package; setup replays from the seed, then the resident
    buffers (f32 holds the bf16 and int32 leaves exactly), the planner's
    state and rng stream and the history are restored, and the token
    streams skip the rounds already run (``worker_streams(skip_rounds=)``):
    the continuation is the uninterrupted run's.  ``init``
    replaces the port's own initialisation with the JAX package's resident
    buffers ``(fleet.pbuf, fleet.obuf)`` as numpy arrays
    (``flat_state.fleet_from_reference``).

    ``run.mesh_shards > 1``: called from a plain process, this spawns the
    mesh's ranks (``launch.mesh.spawn``) and returns rank 0's result, the
    fleet crossing back through a pipe as numpy arrays; called inside a
    process group of that size, it runs this rank's share.  A rank holds its
    block of the padded ``pbuf``/``obuf`` (same init draw at every shard
    count), trains only the activated rows of its block on their batches
    (with ``host_batch_gather``, only those rows are gathered), and
    all-reduces the Eq. 4 partial products or union slab, the Eq. 11
    partial sum and, at history points, the round losses.  After the last
    round the blocks are gathered to rank 0 through host memory (gloo) and
    rank 0 returns the fleet with every row; the other ranks return
    ``(None, history)``.  Snapshots are gathered to rank 0 the same way
    (into host memory) and written by rank 0 alone; on resume every rank
    reads the snapshot and takes its block.  At smollm-135m's full width
    with 8 workers the final assembly moves 12.9 GB (f32 params and Adam's
    two moments) through the host and holds the whole fleet on rank 0's
    device beside its optimizer-state block.
    """
    check_trainable(cfg)
    if run.mesh_shards > 1 and not run.resident_fleet:
        raise ValueError("mesh_shards > 1 requires the resident engine "
                         "(resident_fleet=True)")
    dev = resolve_device(device if device is not None else run.device,
                         "run_lm_federation")
    if run.mesh_shards > 1 and not MESH.in_group():
        pbuf, obuf, hist = MESH.spawn(_lm_rank, run.mesh_shards, mechanism,
                                      cfg, run, str(dev), init, resume_from,
                                      device=dev)
        opt = get_optimizer(run.optimizer, run.lr)
        spec, _ = _fleet_spec(R.init_params(cfg, None), opt)
        return LMFleet(cfg=cfg, pbuf=torch.from_numpy(pbuf).to(dev),
                       obuf=torch.from_numpy(obuf).to(dev), spec=spec,
                       optimizer=opt, n_workers=run.n_workers), hist
    t_wall = time.time()
    n = run.n_workers
    shd = (FleetSharding.create(run.mesh_shards, n, dev)
           if run.mesh_shards > 1 else None)
    if shd is not None:
        dev = shd.device
    rng = np.random.default_rng(run.seed)
    fleet = init_fleet(cfg, n, optimizer=run.optimizer, lr=run.lr,
                       seed=run.seed, device=dev, shd=shd)
    if init is not None:
        if init[0].shape[0] != n:
            raise ValueError(f"run_lm_federation: init holds "
                             f"{init[0].shape[0]} workers, the run {n}")
        pb, ob = FS.fleet_from_reference(init[0], init[1], fleet.spec,
                                         dev if shd is None else "cpu")
        fleet.pbuf, fleet.obuf = ((pb, ob) if shd is None else
                                  (shd.put_rows_padded(pb),
                                   shd.put_rows_padded(ob)))
    streams = worker_streams(cfg, n, run.batch, run.seq, seed=run.seed)
    ev = next(worker_streams(cfg, 1, run.batch, run.seq, seed=run.seed + 1))
    eval_tok = torch.from_numpy(ev["tokens"][0]).to(dev)
    eval_lab = torch.from_numpy(ev["labels"][0]).to(dev)
    net = EdgeNetwork(NetworkConfig(n_workers=n,
                                    comm_range_m=run.comm_range_m), rng)
    h_i = heterogeneous_compute_times(n, 1.0, rng, sigma=run.compute_sigma)
    model_bytes = float(fleet.model_bytes)
    scen = resolve_scenario(run.scenario, n, run.n_rounds, dist=net.dist,
                            comm_range_m=net.cfg.comm_range_m)
    planner = HorizonPlanner(
        mechanism, h_i=h_i, in_range=net.in_range(),
        exp_link_time=net.expected_link_time(model_bytes),
        model_bytes=model_bytes, class_counts=np.ones((n, 2)),
        data_sizes=np.ones(n), net=net, rng=rng, tau_bound=run.tau_bound,
        bandwidth_budget=run.bandwidth_budget,
        link_timeout_s=run.link_timeout_s,
        sync_link_timeout_s=run.sync_link_timeout_s,
        failure_prob=run.failure_prob, failure_persist=run.failure_persist,
        mesh_shards=run.mesh_shards, scenario=scen)
    alpha = torch.full((n,), 1.0 / n, dtype=F32)
    alpha = alpha.to(dev) if shd is None else shd.put_rows_padded(alpha)
    hist = LMHistory()
    if shd is not None:
        hist.mesh_backend = shd.mesh.backend
    run_config = {"plane": "lm", "n_workers": n, "seed": run.seed,
                  "resident_fleet": run.resident_fleet,
                  "mesh_shards": run.mesh_shards, "arch": cfg.arch_id,
                  "optimizer": run.optimizer,
                  "scenario": scen.schedule.name if scen else None}

    # --- resume: overwrite the deterministic setup's mutable state
    # (resident buffers, planner state and rng stream, history) and skip
    # the token streams past the snapshot's rounds
    if resume_from is not None:
        ck = CIO.resolve_snapshot(resume_from)
        arr_tmpl = {k: np.zeros_like(v)
                    for k, v in planner.state_dict()["arrays"].items()}
        model_tmpl = {
            "pbuf": np.zeros((n, fleet.spec.params.n_params), np.float32),
            "obuf": np.zeros((n, fleet.spec.opt.n_params), np.float32)}
        CIO.check_resume_config(ck, CIO.read_checkpoint(ck, ())[1],
                                run_config)
        model, arrays, extra = CIO.load_checkpoint(ck, model_tmpl, arr_tmpl)
        planner.load_state({"arrays": arrays,
                            "scalars": extra["planner_scalars"],
                            "rng_state": extra["planner_rng"]})
        pb, ob = torch.from_numpy(model["pbuf"]), torch.from_numpy(
            model["obuf"])
        del model
        fleet.pbuf, fleet.obuf = ((pb.to(dev), ob.to(dev)) if shd is None
                                  else (shd.put_rows_padded(pb),
                                        shd.put_rows_padded(ob)))
        del pb, ob
        streams = worker_streams(cfg, n, run.batch, run.seq, seed=run.seed,
                                 skip_rounds=int(extra["round"]))
        for k, v in extra["history"].items():
            if hasattr(hist, k):
                setattr(hist, k, v)
    if run.resident_fleet:
        engine = LMEngine(cfg, fleet.optimizer, fleet.spec,
                          kernels=run.kernels, shd=shd)
        horizon = max(1, run.scan_horizon)
        sp = so = step = None
    else:
        # the oracle's stacked pytrees, materialized once (copies: the
        # resident buffers stay as they are until the write-back)
        engine, horizon = None, 1
        sp = FS.unflatten_tree(fleet.pbuf, fleet.spec.params, copy=True)
        so = FS.unflatten_tree(fleet.obuf, fleet.spec.opt, copy=True)
        step = make_fleet_step(fleet)
    on_card = dev.type == "cuda"
    hist.setup_wall_s = time.time() - t_wall

    pipe = DispatchPipeline(run.pipeline_depth)
    pending: List[Tuple[PlannedRound, Dict[str, np.ndarray]]] = []
    # per chunk: (device (H, N) losses, the H active masks) — fetched only
    # at history boundaries, so chunk dispatches stay queued in between
    loss_rows: List[Tuple[torch.Tensor, List[np.ndarray]]] = []

    def flush():
        nonlocal sp, so
        if step is not None:
            for p, b in pending:
                sp = fleet_mix_stacked(sp, p.W, p.active, p.links,
                                       kernels=run.kernels)
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in b.items()}
                sp, so, losses = step(sp, so, batch, p.active)
                loss_rows.append((losses[None], [p.active]))
            pending.clear()
            return
        plans = [p for p, _ in pending]
        t0 = time.perf_counter()
        spans = list(chunk_spans(plans, n, col_sparse=run.col_sparse_mix,
                                 min_bucket=run.min_bucket,
                                 mesh_shards=run.mesh_shards))
        hist.pack_wall_s += time.perf_counter() - t0
        for lo, hi, key in spans:
            chunk = plans[lo:hi]
            col = run.col_sparse_mix and prefer_cols(key[0], key[2], n)
            fuse = all(mix_is_train(p) for p in chunk)
            t0 = time.perf_counter()
            tokens = np.stack([b["tokens"] for _, b in pending[lo:hi]])
            labels = np.stack([b["labels"] for _, b in pending[lo:hi]])
            hist.pack_wall_s += time.perf_counter() - t0
            fleet.pbuf, fleet.obuf, losses = engine.dispatch_chunk(
                fleet.pbuf, fleet.obuf, chunk, tokens, labels, key=key,
                col_sparse=col, fuse=fuse, min_bucket=run.min_bucket,
                pregather=run.host_batch_gather, walls=hist)
            loss_rows.append((losses, [p.active for p in chunk]))
            token = None
            if on_card:
                token = torch.cuda.Event()
                token.record()
            pipe.submit(token)
        pending.clear()

    def drain_losses():
        for losses, actives in loss_rows:
            if shd is not None:        # each rank filled its own rows
                shd.psum(losses)
            for row, active in zip(losses[:, :n].cpu().numpy(), actives):
                hist.round_loss.append(float(row[active].mean())
                                       if active.any() else 0.0)
        loss_rows.clear()

    def save_snapshot(t: int) -> None:
        """Atomic snapshot of the whole fleet (f32 ``pbuf``/``obuf`` hold
        every leaf exactly), the planner's state and rng stream and the
        history; called after a drain, so the buffers are round-consistent.
        Under a mesh rank 0 gathers the blocks into host memory and alone
        writes."""
        if step is not None:
            pb = FS.flatten_tree(sp)[0].cpu()
            ob = FS.flatten_tree(so)[0].cpu()
        elif shd is None:
            pb, ob = fleet.pbuf.cpu(), fleet.obuf.cpu()
        else:
            pb = shd.gather_rows(fleet.pbuf, device="cpu")
            ob = shd.gather_rows(fleet.obuf, device="cpu")
            if shd.rank != 0:
                return
        snap = planner.state_dict()
        extra = {"round": t, "planner_scalars": snap["scalars"],
                 "planner_rng": snap["rng_state"],
                 "history": hist.to_dict(), "config": run_config}
        CIO.save_checkpoint(CIO.checkpoint_path(run.checkpoint_dir, t),
                            {"pbuf": pb.numpy(), "obuf": ob.numpy()},
                            opt_state=snap["arrays"], extra=extra)
        CIO.prune_checkpoints(run.checkpoint_dir, run.checkpoint_keep)

    while planner.t < run.n_rounds:
        t0p = time.perf_counter()
        p = planner.plan_round()
        if engine is not None:
            # resolve the shape-bucket key at plan time (memoized on the
            # plan)
            bucket_key(p, n, col_sparse=run.col_sparse_mix,
                       min_bucket=run.min_bucket,
                       mesh_shards=run.mesh_shards)
        hist.plan_wall_s += time.perf_counter() - t0p
        b = next(streams)                 # one draw per round
        hist.round_durations.append(p.duration)
        hist.round_active.append(int(p.active.sum()))
        pending.append((p, b))
        do_eval = p.t % run.eval_every == 0 or p.t == run.n_rounds
        do_ckpt = (run.checkpoint_every > 0
                   and p.t % run.checkpoint_every == 0)
        at_boundary = scen is not None and (p.t + 1) in scen.boundaries
        if do_eval or do_ckpt or at_boundary or len(pending) >= horizon:
            flush()
            # read-back boundaries see round-consistent resident buffers
            if do_eval or do_ckpt or at_boundary:
                pipe.drain()
        if do_eval:
            t_ev = time.time()
            drain_losses()
            if engine is not None:
                lg = float(engine.eval_global(fleet.pbuf, alpha, eval_tok,
                                              eval_lab))
            else:
                lg = fleet_eval_stacked(cfg, sp, _batch(eval_tok, eval_lab),
                                        alpha)
            hist.rounds.append(p.t)
            hist.sim_time.append(planner.sim_clock)
            hist.comm_gb.append(planner.comm_bytes / 1e9)
            hist.loss_global.append(lg)
            hist.loss_local.append(hist.round_loss[-1])
            hist.staleness_avg.append(float(planner.st.tau.mean()))
            hist.staleness_max.append(int(planner.st.tau.max()))
            hist.eval_wall_s += time.time() - t_ev
        if do_ckpt:
            # after the eval (the snapshot's history carries the eval point)
            # and with the losses drained, so round_loss is whole up to t
            drain_losses()
            save_snapshot(p.t)

    flush()
    pipe.drain()
    hist.drain_wall_s += pipe.drain_wall_s
    drain_losses()
    if step is not None:
        fleet.stacked_params = sp         # the oracle's state, written back
        fleet.stacked_opt = so
    if shd is not None:
        # every row of the fleet on rank 0; each block is freed as its
        # assembled buffer replaces it
        fleet.pbuf = shd.gather_rows(fleet.pbuf)
        fleet.obuf = shd.gather_rows(fleet.obuf)
        if shd.rank != 0:
            fleet = None
    hist.wall_s = time.time() - t_wall
    return fleet, hist


def _lm_rank(mechanism, cfg: ModelConfig, run: LMRunConfig, device: str,
             init, resume_from) -> Tuple[Optional[np.ndarray],
                                         Optional[np.ndarray], LMHistory]:
    """One rank of a spawned LM mesh: its share of the run; rank 0 returns
    the assembled buffers as numpy arrays (no CUDA tensor may outlive the
    rank)."""
    fleet, hist = run_lm_federation(mechanism, cfg, run, resume_from,
                                    device=device, init=init)
    if fleet is None:
        return None, None, hist
    return fleet.pbuf.cpu().numpy(), fleet.obuf.cpu().numpy(), hist

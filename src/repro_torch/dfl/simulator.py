"""Event-driven ADFL simulator (paper sections III, VI) on the fused engine.

Time model:
  h_t^{i,cmp} = max(h_i - time-since-last-activation, 0)      (Eq. 7)
  H_t^i       = h^cmp + max over pulled in-links of h^com     (Eq. 8)
  H_t         = max over activated workers of H_t^i           (Eq. 9)
Bandwidth:
  B_t^i = (#in-links + #out-links) * b                        (Eq. 10)
Communication overhead metric = total model-transfer bytes.

The host planner (``core.planner.HorizonPlanner``) resolves each round's
control plane; pending rounds go to the device in bucket-uniform chunks
(``dfl.worker.mega_round_step``), with the flat (N, P) model buffer resident
on ``device`` and updated in place.  ``fused_engine=False`` runs the legacy
per-leaf path instead, one round at a time: the dense Eq. 4 mix of every
leaf (``core.aggregation.apply_mixing``), minibatches from a numpy stream
(``_sample_batches``) and masked SGD of all N workers
(``dfl.worker.local_train``).  With ``mesh_shards > 1`` the buffer is
row-partitioned over a fleet mesh of that many processes
(``launch.mesh``, ``sharding.rules.FleetSharding``).  ``checkpoint_every``
writes atomic snapshots (``checkpoint.io``) that ``resume_from`` continues
exactly.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import ClassVar, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import io as CIO
from repro_torch.core.aggregation import apply_mixing, prefer_cols
from repro_torch.core.planner import (HorizonPlanner, PlannedRound,
                                      bucket_key, chunk_spans, mix_is_train)
from repro_torch.core.protocol import Mechanism
from repro_torch.core.scenarios import resolve_scenario
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import (ClassificationData,
                                        make_classification, train_test_split)
from repro_torch.device import resolve_device
from repro_torch.dfl import flat_state as FS
from repro_torch.dfl import worker as WK
from repro_torch.dfl.network import (EdgeNetwork, NetworkConfig,
                                     heterogeneous_compute_times)
from repro_torch.dfl.pipeline import DispatchPipeline
from repro_torch.kernels import fused_sgd as FSGD
from repro_torch.kernels.config import KernelConfig
from repro_torch.launch import mesh as MESH
from repro_torch.sharding.rules import FleetSharding


@dataclasses.dataclass
class SimConfig:
    """Simulation-plane configuration (the JAX package's ``SimConfig``, plus
    ``device``).

    ``scan_horizon``: the control plane is model-value-independent, so the
    planner resolves up to this many rounds ahead on the host and the engine
    runs them as one mega-round (``dfl.worker.mega_round_step``).  Horizons
    are chopped at eval / history points and at the round cap, so histories
    are identical at any horizon.

    ``pipeline_depth``: at most this many chunks in flight on the card while
    the host plans, packs and stages the next (``dfl.pipeline``); 0 is
    lockstep.  Trajectories are identical at every depth.

    ``device``: where the model plane runs — ``"cuda"`` (the default; the
    run raises if there is no CUDA card) or ``"cpu"``, where the kernels'
    plain PyTorch versions run.  The control plane always runs on the host.

    ``mesh_shards > 1`` row-partitions the buffer and the training data over
    a fleet mesh of that many ranks (one process each; ``launch.mesh``
    states the backend rule).  Every rank plans the same rounds; histories
    are identical to the unsharded run's on the control plane and agree to
    f32 sum-order tolerance on the model plane.

    ``checkpoint_every > 0`` snapshots the run every that many rounds into
    ``checkpoint_dir`` (the JAX package's npz layout, ``checkpoint.io``),
    keeping the ``checkpoint_keep`` newest; snapshot rounds are flush
    boundaries with the pipeline drained, in every checkpointing run.

    ``use_kernel`` is the JAX package's deprecated kernel alias: here the
    tensor's device picks the kernel, so it warns and changes nothing.

    ``fused_engine=False`` is the legacy per-leaf path, the JAX package's
    correctness oracle: a stacked dict of tensors, one round per dispatch,
    Eq. 4 as the dense (N, N) ``aggregate`` of each leaf, and minibatches
    drawn from ``np.random.default_rng(seed + 0x5EED)`` on the host exactly
    as the JAX package draws them, so the two packages train on the same
    batches.  It shares the fused engine's control-plane rng stream (the
    control plane is identical), not its batches; it takes no mesh
    (``mesh_shards > 1`` raises ``ValueError`` when the run starts), and
    ``scan_horizon``, ``pipeline_depth``, ``col_sparse_mix``,
    ``fused_local_sgd`` and ``min_bucket`` do not apply to it.
    """
    n_workers: int = 100
    n_rounds: int = 300               # round cap
    max_sim_time: Optional[float] = None   # stop at this simulated wall-clock;
                                      #   evals then happen on a time grid
    phi: float = 1.0                  # Dirichlet non-IID level (1.0 = IID)
    tau_bound: int = 5
    V: float = 10.0
    batch_size: int = 32
    local_steps: int = 2
    lr: float = 0.05
    hidden: int = 64
    base_compute_s: float = 1.0
    compute_sigma: float = 0.75       # lognormal spread of worker speeds
    bandwidth_budget: float = 8.0     # transfers of size b per worker per round
    link_timeout_s: float = 5.0       # async pull abort/retry ceiling
    sync_link_timeout_s: float = 30.0 # sync barrier stall+retry ceiling
    model_bytes_scale: float = 25.0   # time/bandwidth accounting prices a
                                      #   paper-scale CNN (~0.7MB) rather than
                                      #   the 27KB MLP proxy trained here
    failure_prob: float = 0.0         # per-round chance a worker goes down
    failure_persist: float = 0.5      # chance a down worker stays down
    eval_every: int = 10
    target_accuracy: Optional[float] = None
    seed: int = 0
    use_kernel: bool = False          # deprecated alias; changes nothing
    kernels: Optional[KernelConfig] = None  # kernel tile sizes; None =
                                      #   KernelConfig()
    fused_engine: bool = True         # False = the legacy per-leaf path
    scan_horizon: int = 8             # rounds per mega-round (see above)
    pipeline_depth: int = 1           # chunks in flight (see above)
    col_sparse_mix: bool = True       # contract Eq. 4 over the gathered
                                      #   union of nonzero mixing COLUMNS —
                                      #   (k, u) @ (u, P) — instead of the
                                      #   row-sparse (k, N) @ (N, P) oracle
    fused_local_sgd: bool = True      # the fused SGD kernel; off = the
                                      #   autograd oracle (non-MLP specs fall
                                      #   back to it automatically)
    mesh_shards: int = 1              # row-partition the buffer over ranks
    min_bucket: int = 8               # smallest power-of-two shape bucket;
                                      #   any value yields identical
                                      #   trajectories
    n_samples: int = 20000
    dim: int = 32
    scenario: Optional[object] = None # None, a preset name ("churn20",
                                      #   "blackout", "straggler_tail",
                                      #   "mobile"), or a ScenarioSchedule
    checkpoint_every: int = 0         # rounds between snapshots; 0 = off
    checkpoint_dir: Optional[str] = None
    checkpoint_keep: int = 3
    device: str = "cuda"              # where the model plane runs

    def __post_init__(self):
        for f in ("failure_prob", "failure_persist"):
            v = getattr(self, f)
            if not (0.0 <= v <= 1.0):
                raise ValueError(
                    f"SimConfig.{f} must be a probability in [0, 1], got "
                    f"{v} — out-of-range values silently degenerate the "
                    f"edge-dynamics mask to 'never' or 'always'")
        for f in ("link_timeout_s", "sync_link_timeout_s", "base_compute_s",
                  "lr", "model_bytes_scale", "bandwidth_budget"):
            v = getattr(self, f)
            if v <= 0:
                raise ValueError(f"SimConfig.{f} must be > 0, got {v} — a "
                                 f"non-positive value makes Eq. 7-9 round "
                                 f"durations meaningless")
        for f in ("n_workers", "n_rounds", "batch_size", "local_steps",
                  "eval_every", "scan_horizon", "mesh_shards", "min_bucket"):
            v = getattr(self, f)
            if v < 1:
                raise ValueError(f"SimConfig.{f} must be >= 1, got {v}")
        if self.pipeline_depth < 0:
            raise ValueError(f"SimConfig.pipeline_depth must be >= 0 "
                             f"(0 = lockstep oracle), got "
                             f"{self.pipeline_depth}")
        if self.checkpoint_every < 0:
            raise ValueError(f"SimConfig.checkpoint_every must be >= 0 "
                             f"(0 disables snapshots), got "
                             f"{self.checkpoint_every}")
        if self.checkpoint_every > 0 and not self.checkpoint_dir:
            raise ValueError(
                "SimConfig.checkpoint_every > 0 needs checkpoint_dir: pass "
                "the directory snapshots should land in")
        if self.kernels is not None and not isinstance(self.kernels,
                                                       KernelConfig):
            raise ValueError(
                f"SimConfig.kernels must be a kernels.config.KernelConfig "
                f"(or None for the default tiles), got "
                f"{type(self.kernels).__name__}")
        if self.kernels is None:
            self.kernels = KernelConfig()
        if str(self.device).split(":")[0] not in ("cpu", "cuda"):
            raise ValueError(f"SimConfig.device must be 'cuda' (the card) or "
                             f"'cpu', got {self.device!r}")
        if self.use_kernel:
            warnings.warn(
                "SimConfig.use_kernel is deprecated and changes nothing: "
                "the tensor's device picks the kernel (CUDA tensors run the "
                "CUDA kernels, CPU tensors their plain versions)",
                DeprecationWarning, stacklevel=2)


@dataclasses.dataclass
class History:
    """Per-eval-point trajectory of one simulation run.

    Units: ``sim_time`` is simulated edge wall-clock SECONDS (sum of Eq. 9
    round durations — the paper's x-axis); ``comm_gb`` cumulative transfer
    volume in GB (Eq. 10 accounting at ``model_bytes_scale`` pricing);
    ``staleness_avg``/``staleness_max`` are in ROUNDS since last activation
    (Eq. 6).  The ``*_wall_s`` fields are REAL host seconds: ``plan_wall_s``
    in ``planner.plan_round``, ``pack_wall_s`` chunk splitting, packing and
    batch drawing, ``stage_wall_s`` host-to-device staging and the batch
    gather launch, ``drain_wall_s`` the host blocked on the device.
    ``mesh_backend`` is the fleet mesh's collective backend ("gloo" or
    "nccl"; None without a mesh).
    """
    rounds: List[int] = dataclasses.field(default_factory=list)
    sim_time: List[float] = dataclasses.field(default_factory=list)
    comm_gb: List[float] = dataclasses.field(default_factory=list)
    acc_global: List[float] = dataclasses.field(default_factory=list)
    acc_local: List[float] = dataclasses.field(default_factory=list)
    loss_global: List[float] = dataclasses.field(default_factory=list)
    staleness_avg: List[float] = dataclasses.field(default_factory=list)
    staleness_max: List[int] = dataclasses.field(default_factory=list)
    completion_time: Optional[float] = None     # first time target acc reached
    completion_comm_gb: Optional[float] = None
    wall_s: float = 0.0
    eval_wall_s: float = 0.0      # host wall spent in eval passes
    setup_wall_s: float = 0.0     # one-time setup before the round loop
    round_durations: List[float] = dataclasses.field(default_factory=list)
    round_active: List[int] = dataclasses.field(default_factory=list)
    plan_wall_s: float = 0.0
    pack_wall_s: float = 0.0
    stage_wall_s: float = 0.0
    drain_wall_s: float = 0.0
    # a class attribute, not a field (the fields mirror the JAX package's);
    # a mesh run sets it on its history
    mesh_backend: ClassVar[Optional[str]] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def run_simulation(mechanism: Mechanism, cfg: SimConfig,
                   data: Optional[ClassificationData] = None,
                   test: Optional[ClassificationData] = None,
                   record_history_for_bound: bool = False, *,
                   device: Optional[str] = None,
                   init: Optional[Dict[str, np.ndarray]] = None,
                   resume_from: Optional[str] = None) -> History:
    """Run (or resume) one simulation-plane federation.

    ``resume_from``: a snapshot file (or a checkpoint directory, meaning its
    newest snapshot) written by a ``checkpoint_every`` run of the same
    config, by this port or by the JAX package.  Setup replays from
    ``cfg.seed`` (the same rng draws), then the model rows, the planner's
    control state and rng stream, and the history are restored: the
    continued run is the uninterrupted one's on the control plane, and its
    learning curve too (batches are drawn per (seed, round, worker); on
    the legacy path the snapshot carries the batch stream's state).

    ``device`` overrides ``cfg.device`` ("cuda" unless the caller asks for
    "cpu").  ``init`` replaces the port's own initialisation with stacked
    parameters of the JAX package (numpy arrays with a leading worker axis;
    the buffer's columns are the same); the control plane does not depend
    on the init.

    ``cfg.mesh_shards > 1``: called from a plain process, this spawns the
    mesh's ranks (``launch.mesh.spawn``) and returns rank 0's history;
    called inside a process group of that size, it runs this rank's share:
    the rank holds its block of the padded buffer and the training samples
    of its own workers, stages only its rows' minibatches (drawn per
    (seed, round, worker) as ever, so identical at every shard count),
    and all-reduces the Eq. 4 partial products or union slab and the
    Eq. 11 partial sums.  Rank 0 alone writes the snapshots (the blocks
    gathered, the padding rows left out); on resume every rank reads the
    snapshot and takes its block.
    """
    if resume_from is not None and record_history_for_bound:
        raise ValueError("resume_from cannot record a bound log: the "
                         "pre-kill rounds' active/W history is not "
                         "checkpointed")
    if cfg.mesh_shards > 1 and not cfg.fused_engine:
        raise ValueError(
            "mesh_shards > 1 requires the fused engine (fused_engine=True): "
            "the legacy per-leaf path has no resident buffer to shard")
    dev = resolve_device(device if device is not None else cfg.device,
                         "run_simulation")
    if cfg.mesh_shards > 1 and not MESH.in_group():
        return MESH.spawn(_sim_rank, cfg.mesh_shards, mechanism, cfg, data,
                          test, record_history_for_bound, str(dev), init,
                          resume_from, device=dev)
    shd = (FleetSharding.create(cfg.mesh_shards, cfg.n_workers, dev)
           if cfg.mesh_shards > 1 else None)
    if shd is not None:
        dev = shd.device
    rng = np.random.default_rng(cfg.seed)
    t_wall = time.time()

    # --- data ---
    if data is None:
        full = make_classification(cfg.n_samples, cfg.dim, seed=cfg.seed)
        data, test_split = train_test_split(full, 0.2, seed=cfg.seed)
        test = test or test_split
    if test is None:
        raise ValueError("run_simulation: pass `test` when supplying `data`")
    parts, class_counts = dirichlet_partition(data, cfg.n_workers, cfg.phi,
                                              seed=cfg.seed)
    data_sizes = np.array([len(p) for p in parts], np.float64)
    alpha = torch.tensor(data_sizes / data_sizes.sum(), dtype=torch.float32)
    alpha = alpha.to(dev) if shd is None else shd.put_rows_padded(alpha)

    # --- environment ---
    net = EdgeNetwork(NetworkConfig(n_workers=cfg.n_workers), rng)
    in_range = net.in_range()
    h_i = heterogeneous_compute_times(cfg.n_workers, cfg.base_compute_s, rng,
                                      sigma=cfg.compute_sigma)

    # --- models: the fused engine's only storage is the flat buffer, the
    # legacy path's a stacked dict
    if init is None:
        stacked = WK.init_stacked(torch.Generator().manual_seed(cfg.seed),
                                  cfg.n_workers, cfg.dim, cfg.hidden,
                                  data.n_classes)
    else:
        stacked = {k: torch.tensor(np.asarray(v)) for k, v in init.items()}
    flat_spec = FS.spec_of(stacked)
    if init is not None:
        want = FS.spec_of(WK.init_stacked(torch.Generator(), 1, cfg.dim,
                                          cfg.hidden, data.n_classes))
        n_init = len(next(iter(stacked.values())))
        if (n_init != cfg.n_workers or flat_spec.keys != want.keys
                or flat_spec.shapes != want.shapes):
            raise ValueError(
                f"run_simulation: init has {n_init} workers of leaves "
                f"{dict(zip(flat_spec.keys, flat_spec.shapes))}; the config "
                f"needs {cfg.n_workers} of "
                f"{dict(zip(want.keys, want.shapes))}")
    fused_sgd = (cfg.fused_engine and cfg.fused_local_sgd
                 and WK.fused_sgd_supported(flat_spec))
    if fused_sgd and dev.type == "cuda":
        # an MLP the kernel cannot hold is refused here, not in round 1
        FSGD.check_sizes(flat_spec, cfg.local_steps, cfg.batch_size)
    model_bytes = WK.param_bytes({k: v[0] for k, v in stacked.items()}) \
        * cfg.model_bytes_scale
    exp_link_time = net.expected_link_time(model_bytes)
    buf = batch_rng = None
    if cfg.fused_engine:
        buf = FS.flatten_stacked(stacked)[0]
        buf = buf.to(dev) if shd is None else shd.put_rows_padded(buf)
        stacked = None
    else:
        stacked = {k: v.to(dev) for k, v in stacked.items()}
        # the JAX package's legacy batch stream, consumed as it consumes it
        batch_rng = np.random.default_rng(cfg.seed + WK.BATCH_STREAM)
    # the device-resident dataset; a rank holds its own workers' samples,
    # and ``local_of`` maps a sample id to its row there
    local_of, samples = None, slice(None)
    if shd is not None:
        lo = shd.home[0]
        own = [parts[w] for w in range(lo, lo + shd.n_home_real)]
        samples = np.unique(np.concatenate(own)) if own else np.zeros(0, int)
        local_of = np.full(len(data.x), -1, np.int64)
        local_of[samples] = np.arange(len(samples))
    data_x = torch.from_numpy(data.x[samples]).to(dev)
    data_y = torch.from_numpy(data.y[samples]).to(dev)

    # --- control plane: the horizon planner owns all mutable control state
    scen = resolve_scenario(cfg.scenario, cfg.n_workers, cfg.n_rounds,
                            dist=net.dist, comm_range_m=net.cfg.comm_range_m)
    planner = HorizonPlanner(
        mechanism, h_i=h_i, in_range=in_range, exp_link_time=exp_link_time,
        model_bytes=model_bytes, class_counts=class_counts,
        data_sizes=data_sizes, net=net, rng=rng, tau_bound=cfg.tau_bound,
        bandwidth_budget=cfg.bandwidth_budget,
        link_timeout_s=cfg.link_timeout_s,
        sync_link_timeout_s=cfg.sync_link_timeout_s,
        failure_prob=cfg.failure_prob, failure_persist=cfg.failure_persist,
        mesh_shards=cfg.mesh_shards, scenario=scen)
    x_test = torch.from_numpy(test.x).to(dev)
    y_test = torch.from_numpy(test.y).to(dev)

    hist = History()
    if shd is not None:
        hist.mesh_backend = shd.mesh.backend
    bound_log = {"active": [], "W": []} if record_history_for_bound else None
    run_config = {"plane": "sim", "n_workers": cfg.n_workers,
                  "seed": cfg.seed, "fused_engine": cfg.fused_engine,
                  "mesh_shards": cfg.mesh_shards,
                  "scenario": scen.schedule.name if scen else None}

    # --- resume: overwrite the deterministic setup's mutable state (model
    # rows, planner state and rng stream, history) with the snapshot's
    if resume_from is not None:
        ck = CIO.resolve_snapshot(resume_from)
        arr_tmpl = {k: np.zeros_like(v)
                    for k, v in planner.state_dict()["arrays"].items()}
        model_tmpl = (stacked if stacked is not None else
                      {"buf": np.zeros((cfg.n_workers, flat_spec.n_params),
                                       np.float32)})
        CIO.check_resume_config(ck, CIO.read_checkpoint(ck, ())[1],
                                run_config)
        model, arrays, extra = CIO.load_checkpoint(ck, model_tmpl, arr_tmpl)
        planner.load_state({"arrays": arrays,
                            "scalars": extra["planner_scalars"],
                            "rng_state": extra["planner_rng"]})
        if stacked is not None:
            stacked = model
            batch_rng.bit_generator.state = extra["batch_rng"]
        else:
            restored = torch.from_numpy(model["buf"])
            buf = (restored.to(dev) if shd is None
                   else shd.put_rows_padded(restored))
        for k, v in extra["history"].items():
            if hasattr(hist, k):
                setattr(hist, k, v)
    horizon = cfg.scan_horizon if cfg.fused_engine else 1
    pipe = DispatchPipeline(cfg.pipeline_depth)
    on_card = dev.type == "cuda"

    def stage(a: np.ndarray) -> torch.Tensor:
        """Host array -> device, without waiting for queued launches."""
        t = torch.from_numpy(a)
        return t.pin_memory().to(dev, non_blocking=True) if on_card else t

    def flush_legacy(plans: List[PlannedRound]) -> None:
        """The legacy path's rounds, one at a time: Eq. 4 on every leaf,
        then every worker's minibatches and masked Eq. 5 steps."""
        nonlocal stacked
        for p in plans:
            stacked = apply_mixing(p.W, stacked, kernels=cfg.kernels)
            ids = stage(_sample_batches(parts, cfg, batch_rng))
            stacked, _ = WK.local_train(stacked, data_x[ids], data_y[ids],
                                        stage(p.active), lr=cfg.lr,
                                        local_steps=cfg.local_steps)

    def flush(plans: List[PlannedRound]) -> None:
        """Send the pending planned rounds to the model plane (Eq. 4+5):
        consecutive rounds sharing one shape-bucket key go out as one
        mega-round, packed with the uniform-bucket packer."""
        if stacked is not None:
            return flush_legacy(plans)
        t0 = time.perf_counter()
        spans = list(chunk_spans(plans, cfg.n_workers,
                                 col_sparse=cfg.col_sparse_mix,
                                 min_bucket=cfg.min_bucket,
                                 mesh_shards=cfg.mesh_shards))
        hist.pack_wall_s += time.perf_counter() - t0
        for lo, hi, key in spans:
            chunk = plans[lo:hi]
            # the per-chunk traffic model picks the cheaper contraction
            col = cfg.col_sparse_mix and prefer_cols(key[0], key[2],
                                                     cfg.n_workers)
            t0 = time.perf_counter()
            w_h, ctrl_h, ts = WK.pack_chunk(chunk, key,
                                            min_bucket=cfg.min_bucket,
                                            col_sparse=col,
                                            shards=cfg.mesh_shards)
            k_mix = w_h.shape[1]
            u = w_h.shape[2] if col and k_mix else 0
            k_train = (ctrl_h.shape[1] - k_mix - u) // 2
            tids = ctrl_h[:, k_mix + u:k_mix + u + k_train]
            segs = None
            if shd is None:
                ids = (WK.sample_batch_ids(
                    cfg.seed, ts, tids, parts, cfg.local_steps,
                    cfg.batch_size) if k_train else None)
            else:
                if not col:
                    w_h = WK.pad_w_cols(w_h, shd.n_pad)
                segs = WK.shard_segments(ctrl_h, k_mix, u, shd)
                # this rank's train rows' minibatches, round after round
                own = [WK.sample_batch_ids(
                    cfg.seed, ts[h:h + 1], tids[h:h + 1, a:b], parts,
                    cfg.local_steps, cfg.batch_size)[0]
                    for h, (a, b) in enumerate(segs[:, 2:]) if b > a]
                ids = local_of[np.concatenate(own)] if own else None
            mit = fused_sgd and all(mix_is_train(p) for p in chunk)
            t1 = time.perf_counter()
            hist.pack_wall_s += t1 - t0
            w_d, c_d = stage(w_h), stage(ctrl_h)
            xb = yb = None
            if ids is not None:
                ids_d = stage(ids)
                xb, yb = data_x[ids_d], data_y[ids_d]
            hist.stage_wall_s += time.perf_counter() - t1
            WK.mega_round_step(buf, w_d, c_d, xb, yb, spec=flat_spec,
                               lr=cfg.lr, kernels=cfg.kernels, col_sparse=col,
                               fused_sgd=fused_sgd, with_losses=False,
                               mix_is_train=mit, shd=shd, segs=segs)
            token = None
            if on_card:
                token = torch.cuda.Event()
                token.record()
            pipe.submit(token)

    def save_snapshot(t: int) -> None:
        """Atomic snapshot of the model rows, the planner's control state
        and rng stream, and the history; called only after a drain, so the
        buffer is round-consistent.  Under a mesh rank 0 gathers the blocks
        (through host memory) and alone writes."""
        if stacked is not None:
            model = stacked
        else:
            rows = buf if shd is None else shd.gather_rows(buf, device="cpu")
            if shd is not None and shd.rank != 0:
                return
            model = {"buf": rows.cpu().numpy()}
        snap = planner.state_dict()
        extra = {"round": t, "planner_scalars": snap["scalars"],
                 "planner_rng": snap["rng_state"],
                 "history": hist.to_dict(), "config": run_config}
        if batch_rng is not None:
            extra["batch_rng"] = batch_rng.bit_generator.state
        CIO.save_checkpoint(CIO.checkpoint_path(cfg.checkpoint_dir, t),
                            model, opt_state=snap["arrays"], extra=extra)
        CIO.prune_checkpoints(cfg.checkpoint_dir, cfg.checkpoint_keep)

    hist.setup_wall_s = time.time() - t_wall
    pending: list[PlannedRound] = []
    stop = False
    while planner.t < cfg.n_rounds and not stop:
        t0p = time.perf_counter()
        p = planner.plan_round()
        if cfg.fused_engine:
            # resolve the round's shape-bucket key at plan time (memoized
            # on the plan): chunk_spans then only does lookups
            bucket_key(p, cfg.n_workers, col_sparse=cfg.col_sparse_mix,
                       min_bucket=cfg.min_bucket,
                       mesh_shards=cfg.mesh_shards)
        hist.plan_wall_s += time.perf_counter() - t0p
        t = p.t
        sim_clock = planner.sim_clock
        hist.round_durations.append(p.duration)
        hist.round_active.append(int(p.active.sum()))
        if bound_log is not None:
            bound_log["active"].append(p.active.copy())
            bound_log["W"].append(p.W.copy())
        pending.append(p)

        # eval/history points are horizon boundaries, so histories are
        # identical at any scan_horizon
        if cfg.max_sim_time is not None:
            grid = cfg.max_sim_time / 12.0
            crossed = (int(sim_clock / grid)
                       > int((sim_clock - p.duration) / grid))
            do_eval = (crossed or sim_clock >= cfg.max_sim_time
                       or t == cfg.n_rounds)
            stop = sim_clock >= cfg.max_sim_time
        else:
            do_eval = t % cfg.eval_every == 0 or t == cfg.n_rounds
        # snapshot rounds are flush boundaries in every checkpointing run
        # (resumed or not), and scenario event boundaries also flush, keeping
        # mega-rounds from straddling a fault-phase change; eval and
        # save_snapshot read a drained, round-consistent buffer
        do_ckpt = cfg.checkpoint_every > 0 and t % cfg.checkpoint_every == 0
        at_boundary = scen is not None and (t + 1) in scen.boundaries
        if (do_eval or stop or t == cfg.n_rounds or do_ckpt or at_boundary
                or len(pending) >= horizon):
            flush(pending)
            pending = []
            if do_eval or stop or do_ckpt or at_boundary or t == cfg.n_rounds:
                pipe.drain()
        if do_eval:
            t_eval = time.time()
            if stacked is not None:
                accg, lossg = WK.evaluate_global(stacked, alpha, x_test,
                                                 y_test)
                accl, _ = WK.evaluate_stacked(stacked, x_test, y_test)
            else:
                accg, lossg = WK.evaluate_global_flat(
                    buf, alpha, x_test, y_test, spec=flat_spec, shd=shd)
                accl, _ = WK.evaluate_stacked_flat(buf, x_test, y_test,
                                                   spec=flat_spec, shd=shd)
            hist.rounds.append(t)
            hist.sim_time.append(sim_clock)
            hist.comm_gb.append(planner.comm_bytes / 1e9)
            hist.acc_global.append(float(accg))
            hist.acc_local.append(float(accl))
            hist.loss_global.append(float(lossg))
            hist.staleness_avg.append(float(planner.st.tau.mean()))
            hist.staleness_max.append(int(planner.st.tau.max()))
            if (cfg.target_accuracy is not None
                    and hist.completion_time is None
                    and float(accg) >= cfg.target_accuracy):
                hist.completion_time = sim_clock
                hist.completion_comm_gb = planner.comm_bytes / 1e9
            hist.eval_wall_s += time.time() - t_eval
        if do_ckpt:
            # after the eval, so a snapshot at an eval round carries that
            # round's history point and the resumed run never re-evals it
            save_snapshot(t)

    pipe.drain()
    hist.drain_wall_s += pipe.drain_wall_s
    hist.wall_s = time.time() - t_wall
    if bound_log is not None:
        hist.bound_log = bound_log  # type: ignore[attr-defined]
    return hist


def _sim_rank(mechanism, cfg, data, test, record_history_for_bound, device,
              init, resume_from):
    """One rank of a spawned simulation mesh: its share of the run."""
    return run_simulation(mechanism, cfg, data, test,
                          record_history_for_bound, device=device, init=init,
                          resume_from=resume_from)


def _sample_batches(parts, cfg: SimConfig,
                    rng: np.random.Generator) -> np.ndarray:
    """The legacy path's minibatch sample ids, (N, local_steps, batch): one
    ``rng.choice(parts[i], size=(local_steps, batch))`` per worker, in
    worker order, every round — the JAX package's ``_sample_batches``
    draws, whose samples it gathers on the host; here the ids go to the
    device and the resident dataset is gathered there."""
    ids = np.empty((cfg.n_workers, cfg.local_steps, cfg.batch_size),
                   np.int64)
    for i in range(cfg.n_workers):
        ids[i] = rng.choice(parts[i], size=(cfg.local_steps, cfg.batch_size))
    return ids

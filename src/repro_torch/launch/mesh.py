"""Meshes: the production and host mesh descriptions, the card's roofline
constants, and the fleet mesh (one process per shard of the fleet's worker
axis).

``make_production_mesh`` and ``make_host_mesh`` (the ports of the JAX
package's functions of those names) return a ``Mesh``: axis names and
sizes, and the device of a mesh of one.  That is all the logical-axis
rules read (``sharding.rules.logical_spec``, as the JAX package's
``abstract_mesh`` says), so a 256- or 512-device mesh needs no process
group and no card: the dry-run (``launch/dryrun.py``) builds its specs on
one.

A step runs sharded over a mesh of ranks (explicit SPMD, one process per
device): ``make_rank_mesh`` joins the ranks and gives this rank's
``Mesh`` with its coordinate on each axis (``coords``, rank r at the
row-major place of r in the grid, as JAX lays a mesh's devices out) and
one process group per axis (``groups``: every row, column and pod line
of the grid), over which ``sharding.rules``' collectives run.
``rank_view`` is the same place with no process group, on ``meta``: the
dry-run plays one device of a production mesh with it, and its
collectives only shape their outputs and count.

The JAX package's fleet mesh (``repro.launch.mesh.make_fleet_mesh``) is a
1-D device mesh under one controller; GSPMD and ``shard_map`` add the
collectives.  PyTorch's idiom is one process per shard, joined by
``torch.distributed``: each process (a *rank*) holds one contiguous block of
the resident ``(N_pad, P)`` buffers (``sharding.rules.FleetSharding``) and
the collectives are ``dist.all_reduce`` / ``dist.gather`` calls.

Backend rule (``fleet_backend``, one rule for every caller): NCCL when every
rank has a card of its own (device "cuda" and at least ``mesh_shards`` cards
visible; rank r works on ``cuda:r``); gloo when the ranks share a device —
the CPU, or one card that every rank works on.  NCCL refuses two ranks on
one card, while gloo all-reduces CUDA tensors through pinned host memory;
gloo on one card is the same emulation as the JAX package's forced host
devices, and cannot scale.  The handle records the backend.

The ranks meet through a file in a temporary directory (``file://``), never
a fixed TCP port, so meshes started side by side do not collide.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import pickle
import queue
import tempfile
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, the data sheet's dense
# rates: the roofline constants of launch/analysis.py and the kernels'
# bounds (launch/loopcost.py)
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989e12        # tensor cores, per card
PEAK_FLOPS_F32 = 67e12          # CUDA cores, outside the tensor cores
HBM_BW = 3.35e12                # bytes/s per card
HBM_BYTES = 80e9                # device memory per card
NVLINK_BW = 450e9               # bytes/s each way per card (NVLink 4)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh as the logical-axis rules see it: ``axis_names`` with
    their ``sizes`` (major to minor), and the ``device`` of a mesh of one
    (None for a description that no step runs on).  One rank's place on
    it adds ``coords`` (its index on each axis), ``groups`` (axis name ->
    the process group of the ranks that differ from it on that axis
    alone; None on a ``rank_view``) and the collective ``backend``."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: Optional[torch.device] = None
    coords: Optional[Tuple[int, ...]] = None
    groups: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, compare=False, repr=False)
    backend: Optional[str] = None

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes)

    @property
    def ranked(self) -> bool:
        """Whether this is one rank's place on a mesh of more than one
        device (a step run under it is sharded)."""
        return self.coords is not None and self.n_devices > 1

    def size(self, axis: str) -> int:
        """The axis' size (1 for an axis the mesh does not have)."""
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's index on the axis (0 for an axis it does not
        have)."""
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]


def rank_coords(rank: int, sizes: Tuple[int, ...]) -> Tuple[int, ...]:
    """Rank r's coordinate on a grid of ``sizes`` (row-major: the last
    axis varies fastest)."""
    out = []
    for n in reversed(sizes):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _rank_of(coords: Tuple[int, ...], sizes: Tuple[int, ...]) -> int:
    r = 0
    for c, n in zip(coords, sizes):
        r = r * n + c
    return r


def rank_view(mesh: Mesh, rank: int = 0) -> Mesh:
    """Rank ``rank``'s place on ``mesh`` with no process group, on the
    ``meta`` device: what the dry-run counts one device of a production
    mesh with."""
    return Mesh(mesh.axis_names, mesh.sizes, torch.device("meta"),
                rank_coords(rank, mesh.sizes))


def make_rank_mesh(axis_names: Tuple[str, ...], sizes: Tuple[int, ...],
                   device, *, rank: int | None = None,
                   init_file: str | None = None) -> Mesh:
    """Join a mesh of ``prod(sizes)`` ranks, one per device, and return
    this rank's place on it.  The process group is the fleet mesh's
    (``make_fleet_mesh``: an existing group of that size, or ``rank`` and
    ``init_file``; gloo or NCCL by ``fleet_backend``'s rule); every rank
    then creates one group per line of the grid along each axis of more
    than one device, in the same order, and keeps its own."""
    axis_names, sizes = tuple(axis_names), tuple(int(n) for n in sizes)
    fm = make_fleet_mesh(math.prod(sizes), device, rank=rank,
                         init_file=init_file)
    coords = rank_coords(fm.rank, sizes)
    groups: Dict[str, Any] = {}
    for a, name in enumerate(axis_names):
        if sizes[a] == 1:
            continue
        others = [range(n) for i, n in enumerate(sizes) if i != a]
        for rest in itertools.product(*others):
            line = [_rank_of(rest[:a] + (j,) + rest[a:], sizes)
                    for j in range(sizes[a])]
            group = dist.new_group(line)
            if fm.rank in line:
                groups[name] = group
    return Mesh(axis_names, sizes, fm.device, coords, groups, fm.backend)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production meshes: ("data", "model") 16 x 16, or
    with ``multi_pod`` ("pod", "data", "model") 2 x 16 x 16 (the pod axis is
    the DFL worker axis: each pod holds one replica)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(device="cuda") -> Mesh:
    """A 1 x 1 ("data", "model") mesh on one device ("cuda" by default,
    "cpu" or "meta" where the caller asks): every spec is a no-op."""
    return Mesh(("data", "model"), (1, 1),
                resolve_device(device, "make_host_mesh", meta=True))


COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)
_POLL_S = 0.2


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """This process's place in the fleet mesh: ``rank`` of ``n_shards``,
    the collective ``backend`` and the ``device`` its block lives on."""
    n_shards: int
    rank: int
    backend: str
    device: torch.device


def fleet_backend(mesh_shards: int, device) -> str:
    """``"nccl"`` when each of ``mesh_shards`` ranks can have a card of its
    own, else ``"gloo"`` (the ranks share the CPU or one card)."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= mesh_shards):
        return "nccl"
    return "gloo"


def in_group() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def make_fleet_mesh(mesh_shards: int, device, *, rank: int | None = None,
                    init_file: str | None = None) -> FleetMesh:
    """Join the fleet mesh of ``mesh_shards`` ranks.

    A process already in a process group joins it (its world size must be
    ``mesh_shards``).  Otherwise ``rank`` and ``init_file`` (the rendezvous
    file, see ``spawn``) create the group with ``fleet_backend``'s choice.
    """
    if mesh_shards < 1:
        raise ValueError(f"mesh_shards must be >= 1, got {mesh_shards}")
    dev = torch.device(device)
    backend = fleet_backend(mesh_shards, dev)
    if not in_group():
        if rank is None or init_file is None:
            raise ValueError(
                f"make_fleet_mesh: this process is in no process group; "
                f"start the {mesh_shards} ranks with launch.mesh.spawn (or "
                f"pass rank= and init_file=)")
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=mesh_shards,
                                timeout=COLLECTIVE_TIMEOUT)
    elif dist.get_world_size() != mesh_shards:
        raise ValueError(f"make_fleet_mesh: mesh_shards={mesh_shards}, but "
                         f"this process group has {dist.get_world_size()} "
                         f"ranks")
    r = dist.get_rank()
    backend = dist.get_backend()
    if dev.type != "cuda":
        rank_dev = torch.device("cpu")
    elif backend == "nccl":
        rank_dev = torch.device("cuda", r)
    else:
        rank_dev = torch.device("cuda", dev.index if dev.index is not None
                                else torch.cuda.current_device())
    if rank_dev.type == "cuda":
        torch.cuda.set_device(rank_dev)
    return FleetMesh(n_shards=mesh_shards, rank=r, backend=backend,
                     device=rank_dev)


def _portable(exc: BaseException) -> BaseException:
    """``exc`` if it pickles, else a RuntimeError carrying its text."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:       # any pickling failure: send the text instead
        return RuntimeError(f"{type(exc).__name__}: {exc}")


def _rank_main(rank: int, n: int, init_file: str, device: str,
               fn: Callable, args: tuple, results) -> None:
    """One spawned rank: create the group, run ``fn``, report to the
    parent (rank 0 sends its result, every rank its failure).  The ranks
    share the host, so each takes an equal share of its intra-op threads
    (n ranks of the default count would oversubscribe the cores)."""
    torch.set_num_threads(max(1, torch.get_num_threads() // n))
    try:
        make_fleet_mesh(n, device, rank=rank, init_file=init_file)
        out = fn(*args)
        results.put((rank, True, out if rank == 0 else None))
    except BaseException as exc:        # report, then exit nonzero
        results.put((rank, False, (_portable(exc), traceback.format_exc())))
        raise SystemExit(1)
    finally:
        if in_group():
            dist.destroy_process_group()


def spawn(fn: Callable, mesh_shards: int, *args, device="cuda") -> Any:
    """Run ``fn(*args)`` in ``mesh_shards`` fresh processes (the ``spawn``
    start method) joined into one fleet mesh on ``device`` (the card unless
    the caller asks for the CPU), and return rank 0's result.

    ``fn`` must be a module-level function, and its arguments and rank 0's
    result must pickle; the result must hold no CUDA tensor (the rank's
    memory is gone once it exits).  If any rank raises, or exits without a
    result, the other ranks are stopped and that rank's exception is raised
    here with the rank's traceback as a note.  Every process started is
    ended before this returns.
    """
    if mesh_shards < 2:
        raise ValueError(f"spawn: a mesh needs >= 2 ranks, got {mesh_shards}")
    device = resolve_device(device, "spawn")
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, mesh_shards, init_file, str(device),
                                   fn, args, results))
                 for r in range(mesh_shards)]
        for p in procs:
            p.start()
        try:
            out, failure = _collect(procs, results)
            for r, p in enumerate(procs):
                if failure is not None:
                    break                 # the others are stopped below
                p.join()
                if p.exitcode != 0:
                    failure = (r, (RuntimeError(
                        f"rank {r} exited with code {p.exitcode} after "
                        f"reporting success"), ""))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    if failure is not None:
        rank, (exc, tb) = failure
        exc.add_note(f"raised on rank {rank} of {mesh_shards}:\n{tb}")
        exc.add_note(f"exit codes by rank: "
                     f"{[p.exitcode for p in procs]}")
        raise exc
    return out


def _collect(procs, results):
    """Wait until every rank has reported, or one has failed; returns
    (rank 0's result, None) or (None, (rank, (exception, traceback)))."""
    out, reported = None, set()
    while len(reported) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=_POLL_S)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in reported and p.exitcode is not None]
            if not dead:
                continue
            try:                      # its report may still be in the pipe
                rank, ok, payload = results.get(timeout=5.0)
            except queue.Empty:
                r = dead[0]
                return None, (r, (RuntimeError(
                    f"rank {r} exited with code {procs[r].exitcode} without "
                    f"a result"), ""))
        if not ok:
            return None, (rank, payload)
        reported.add(rank)
        if rank == 0:
            out = payload
    return out, None

"""The fleet mesh: one process per shard of the fleet's worker axis.

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
import os
import pickle
import queue
import tempfile
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

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


def spawn(fn: Callable, mesh_shards: int, *args, device="cpu") -> Any:
    """Run ``fn(*args)`` in ``mesh_shards`` fresh processes (the ``spawn``
    start method) joined into one fleet mesh on ``device``, and return rank
    0's result.

    ``fn`` must be a module-level function, and its arguments and rank 0's
    result must pickle; the result must hold no CUDA tensor (the rank's
    memory is gone once it exits).  If any rank raises, or exits without a
    result, the other ranks are stopped and that rank's exception is raised
    here with the rank's traceback as a note.  Every process started is
    ended before this returns.
    """
    if mesh_shards < 2:
        raise ValueError(f"spawn: a mesh needs >= 2 ranks, got {mesh_shards}")
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

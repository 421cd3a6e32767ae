"""The fleet's row partition over the mesh: ``FleetSharding``.

The port of the fleet half of ``repro.sharding.rules`` (``FleetSharding``,
reference lines 181-237).  Under a fleet mesh (``launch.mesh``) every rank
holds one contiguous block of the resident ``(N_pad, P)`` buffers: the
worker axis is zero-padded to a multiple of the shard count (the padding
rows are permanently idle: never activated, mixed or evaluated) and rank r
owns rows ``[r * block, (r + 1) * block)``.  Replicated operands are each
rank's own copy.  The JAX package's ``psum`` is ``psum`` here, an in-place
``dist.all_reduce``.  The logical-axis rules (``DEFAULT_RULES``,
``logical_spec``, ``constrain``, ``tree_shardings``) are not ported: the
fleet does not use them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.planner import shard_spans
from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh

_CHUNK = 1 << 26          # elements per collective call (256 MB in f32)


@dataclasses.dataclass(frozen=True)
class FleetSharding:
    """This rank's view of the fleet's ``n_rows`` workers partitioned over
    ``mesh`` (see module docstring)."""
    mesh: FleetMesh
    n_rows: int

    @classmethod
    def create(cls, mesh_shards: int, n_rows: int, device) -> "FleetSharding":
        """Join the fleet mesh (``launch.mesh.make_fleet_mesh``) and
        partition ``n_rows`` workers over it."""
        return cls(mesh=make_fleet_mesh(mesh_shards, device), n_rows=n_rows)

    @property
    def n_shards(self) -> int:
        return self.mesh.n_shards

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def pad(self) -> int:
        """Permanently idle rows that make the worker axis divisible."""
        return (-self.n_rows) % self.n_shards

    @property
    def n_pad(self) -> int:
        return self.n_rows + self.pad

    @property
    def block(self) -> int:
        """Rows each rank holds."""
        return self.n_pad // self.n_shards

    @property
    def home(self) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` rows of the padded worker axis."""
        return self.rank * self.block, (self.rank + 1) * self.block

    @property
    def n_home_real(self) -> int:
        """Rows of this rank's block that are real workers (not padding)."""
        lo, hi = self.home
        return max(0, min(hi, self.n_rows) - lo)

    def put_rows_padded(self, x) -> torch.Tensor:
        """This rank's block of ``x`` (leading axis ``n_rows``; a tensor or
        a numpy array), zero-padded to ``block`` rows, on its device."""
        lo, _ = self.home
        real = x[lo:lo + self.n_home_real]
        if isinstance(real, np.ndarray):
            real = torch.from_numpy(np.ascontiguousarray(real))
        out = torch.zeros((self.block,) + tuple(real.shape[1:]),
                          dtype=real.dtype, device=self.device)
        out[:len(real)] = real
        return out

    def for_rows(self, row_ids: np.ndarray) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` segment of a home-grouped gathered id
        vector (host ids, ``padded_rows(shards=...)`` layout): the rows it
        computes and scatters back locally."""
        return shard_spans(row_ids, self.n_rows, self.n_shards)[self.rank]

    def local(self, ids: torch.Tensor) -> torch.Tensor:
        """Global row ids of this rank's home rows -> rows of its block."""
        return ids.long() - self.home[0]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place (``dist.all_reduce``, in
        pieces of at most 2^26 elements); returns ``x``."""
        if not x.is_contiguous():
            raise ValueError("psum: the tensor must be contiguous")
        flat = x.view(-1)
        for piece in flat.split(_CHUNK):
            dist.all_reduce(piece)
        return x

    @property
    def _via(self) -> torch.device:
        """Where a gather's pieces travel: the rank's card over NCCL, host
        memory over gloo."""
        return (self.device if self.mesh.backend == "nccl"
                else torch.device("cpu"))

    def gather_rows(self, block: torch.Tensor,
                    device=None) -> Optional[torch.Tensor]:
        """Assemble the ``(n_rows, C)`` buffer from every rank's ``(block,
        C)`` block: rank 0 gets it on ``device`` (its own by default), the
        others None; the padding rows are left out.  Gloo gathers through
        host memory, in column pieces of at most 2^26 elements per rank."""
        rows, cols = block.shape
        via = self._via
        dest = self.device if device is None else torch.device(device)
        full = (torch.empty((self.n_rows, cols), dtype=block.dtype,
                            device=dest) if self.rank == 0 else None)
        step = max(1, _CHUNK // max(rows, 1))
        for c0 in range(0, cols, step):
            piece = block[:, c0:c0 + step].to(via).contiguous()
            parts = ([torch.empty_like(piece) for _ in range(self.n_shards)]
                     if self.rank == 0 else None)
            dist.gather(piece, parts, dst=0)
            if full is not None:
                full[:, c0:c0 + step] = torch.cat(parts)[:self.n_rows].to(
                    dest)
        return full

    def all_gather_rows(self, full: torch.Tensor) -> torch.Tensor:
        """Fill the other ranks' rows of the ``(n_pad, C)`` buffer ``full``,
        in place, from each rank's home rows (``dist.all_gather``: every
        rank gets every row).  Gloo gathers through host memory, in column
        pieces of at most 2^26 elements per rank; returns ``full``."""
        lo, hi = self.home
        step = max(1, _CHUNK // self.block)
        for c0 in range(0, full.shape[1], step):
            piece = full[lo:hi, c0:c0 + step].to(self._via).contiguous()
            parts = [torch.empty_like(piece) for _ in range(self.n_shards)]
            dist.all_gather(parts, piece)
            for r, part in enumerate(parts):
                if r != self.rank:
                    full[r * self.block:(r + 1) * self.block,
                         c0:c0 + step].copy_(part)
        return full

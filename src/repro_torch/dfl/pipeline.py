"""Bounded host/device dispatch pipeline.

CUDA launches return before the card finishes, so while the device executes
horizon chunk H the host can already plan, pack and stage chunk H+1.
``DispatchPipeline`` bounds that overlap: the drive loop ``submit()``s one
``torch.cuda.Event`` recorded after each chunk's launches, and the pipeline
blocks only once more than ``depth`` chunks are outstanding.  Every read-back
boundary (eval, snapshot, scenario event, end of run) calls ``drain()``
first, so a snapshot reads a round-consistent buffer and the planner has
planned no round past it: the snapshot is the same at every depth, and a
run resumed from it is the uninterrupted one's.  Values are untouched — the
pipeline never reorders launches — so trajectories are identical at every
depth.

  * ``depth == 0`` — lockstep: ``submit`` waits for the chunk at once;
  * ``depth >= 1`` — up to that many chunks in flight behind the one being
    staged (1 = double buffering, the default).

On the CPU every launch has finished when it returns, the drive loop submits
``None`` and the pipeline has nothing to wait for.  ``drain_wall_s`` counts
every second the host spent blocked on the device.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional

import torch


class DispatchPipeline:
    """Bounded queue of in-flight chunks (see module docstring)."""

    def __init__(self, depth: int):
        self.depth = max(0, int(depth))
        self._inflight: deque = deque()
        self.drain_wall_s = 0.0

    def _wait(self, token: Optional[torch.cuda.Event]) -> None:
        if token is not None:
            t0 = time.perf_counter()
            token.synchronize()
            self.drain_wall_s += time.perf_counter() - t0

    def submit(self, token: Optional[torch.cuda.Event]) -> None:
        """Register one dispatched chunk (an event recorded after its
        launches, or None on the CPU); waits for the OLDEST chunk(s) once
        more than ``depth`` are outstanding."""
        if self.depth == 0:
            self._wait(token)
            return
        self._inflight.append(token)
        while len(self._inflight) > self.depth:
            self._wait(self._inflight.popleft())

    def drain(self) -> None:
        """Wait until every in-flight chunk has executed."""
        while self._inflight:
            self._wait(self._inflight.popleft())

"""Tile sizes of the port's CUDA kernels.

There is deliberately no backend field: the device of the tensor a wrapper is
given decides what runs (the CUDA kernel on the card, the plain PyTorch
version on the CPU), so no setting can route the card's main path away from
its kernels.
"""
from __future__ import annotations

import dataclasses

_WARP = 32
_MAX_THREADS = 1024


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """``agg_p_blk``: parameter columns per thread block of the Eq. 4
    ``aggregate`` kernel, one column per thread — a multiple of the 32-thread
    warp so every load of a block is whole coalesced warps, and at most 1024
    (the per-block thread limit)."""
    agg_p_blk: int = 128

    def __post_init__(self):
        v = self.agg_p_blk
        if not (isinstance(v, int) and not isinstance(v, bool)
                and 0 < v <= _MAX_THREADS and v % _WARP == 0):
            raise ValueError(
                f"KernelConfig.agg_p_blk={v!r}: must be a positive multiple "
                f"of {_WARP} (one warp of columns) and at most "
                f"{_MAX_THREADS} (threads per block)")

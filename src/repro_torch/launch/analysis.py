"""The roofline of one step at the card's peaks (the port of
``repro.launch.analysis``).

    compute    = counted flops per device / PEAK_FLOPS_BF16
    memory     = counted bytes per device / HBM_BW
    collective = collective bytes per device / NVLINK_BW

The JAX package reads these from the compiled SPMD program (XLA's
``cost_analysis``, ``memory_analysis`` and the post-SPMD HLO's
collectives, per device).  The port has no compiler between the step and
the card: ``extract_roofline`` takes the counts of one eager run of the
step (``launch.loopcost.step_costs``) and the specs of its inputs
(``launch.steps.TrainArtifacts``).

Where the step runs sharded (``sharded=True``: the dense family's train
and prefill steps on a production mesh, counted as one rank's own run on
``meta``, ``launch.mesh.rank_view``) the count is per device already:

* ``flops_per_device`` and ``bytes_per_device`` are that rank's, the work
  it repeats on replicated operands included, as XLA's per-device count
  has it;
* ``collective_bytes_per_device`` is the bytes its collectives report by
  kind (each its result's bytes, the JAX package's convention), and
  ``t_collective`` those bytes over the NVLink rate;
* ``peak_memory_per_device`` is its own peak: its blocks of the
  arguments and the most its run held above them.

Every other step (the other families, the decode shapes, the paper-mode
round; records with ``"sharded": false``) is counted unsharded and split
evenly:

* ``flops_per_device`` and ``bytes_per_device`` split the counted flops and
  bytes evenly over the mesh's devices.  XLA's per-device count includes
  the work each device repeats on replicated operands; an even split does
  not, so on a large mesh these are lower bounds of what a sharded step
  would do;
* ``peak_memory_per_device`` is exact for what the specs place: each
  resident params, optimizer-state, batch and cache leaf's bytes over the
  devices its spec splits it across; plus the step's activation peak (the
  counter's peak above its arguments) split over the devices of the batch
  axes;
* ``t_collective`` is None on a mesh of more than one device: the step
  runs no collective there (items 9(b) and 9(c) of the roadmap).  On the
  host mesh it is the counted collectives' bytes (none) over the NVLink
  rate.

The hardware constants are the H100's (``launch.mesh``); no TPU number is
used.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     Mesh)
from repro_torch.tree import tree_paths


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    mode: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: Optional[float]
    collectives: Dict[str, int]             # calls by kind
    collective_bytes_by_kind: Dict[str, int]
    peak_memory_per_device: Optional[float]
    model_flops: float                      # 6*N*D (or 6*N_active*D for MoE)
    sharded: bool = False                   # counted as one rank's own run

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        if self.collective_bytes_per_device is None:
            return None
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max((k for k, v in terms.items() if v is not None),
                   key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops summed over devices)."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else float("nan")

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "mode": self.mode,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collectives": self.collectives,
            "collective_bytes_by_kind": self.collective_bytes_by_kind,
            "peak_memory_per_device": self.peak_memory_per_device,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "sharded": self.sharded,
        }


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D for training, 2*N*D for forward-only, per the standard rule.
    N = active params (MoE counts routed top-k + shared only)."""
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens


def _split(spec, mesh: Mesh) -> int:
    """How many pieces ``spec`` cuts a tensor into on ``mesh``."""
    sizes = mesh.shape
    n = 1
    for entry in spec:
        for name in (entry,) if isinstance(entry, str) else entry or ():
            n *= sizes[name]
    return n


def resident_bytes_per_device(args, specs, mesh: Mesh) -> int:
    """The bytes one device holds of ``args`` (the step's arguments, trees
    of tensors) laid out by ``specs`` (the matching trees of
    ``PartitionSpec``s)."""
    total = 0
    for tree, spec_tree in zip(args, specs, strict=True):
        for (_, t), (_, s) in zip(tree_paths(tree), tree_paths(spec_tree),
                                  strict=True):
            total += t.numel() * t.element_size() // _split(s, mesh)
    return total


def extract_roofline(cfg, shape, mesh_name: str, mesh: Mesh, mode: str,
                     costs, art, sharded: bool = False) -> Roofline:
    """The roofline of ``art``'s step (``launch.steps.TrainArtifacts``) on
    ``mesh`` from the counts of one run of it (``launch.loopcost.
    step_costs``): of one rank's own run where ``sharded``, else of the
    unsharded step; see the module docstring."""
    n = mesh.n_devices
    if sharded:
        return Roofline(
            arch=cfg.arch_id, shape=shape.name, mesh=mesh_name, mode=mode,
            n_devices=n, flops_per_device=float(costs.dot_flops),
            bytes_per_device=float(costs.io_bytes),
            collective_bytes_per_device=float(sum(
                costs.collectives.values())),
            collectives=dict(costs.collective_calls),
            collective_bytes_by_kind=dict(costs.collectives),
            peak_memory_per_device=float(costs.peak_bytes),
            model_flops=model_flops_estimate(cfg, shape), sharded=True)
    batch = 1 if mode == "prefill" else 2       # the batch's (or token's) slot
    _, batch_spec = tree_paths(art.in_shardings[batch])[0]
    peak = (resident_bytes_per_device(art.abstract_args, art.in_shardings,
                                      mesh)
            + costs.activation_peak_bytes / _split(batch_spec, mesh))
    return Roofline(
        arch=cfg.arch_id, shape=shape.name, mesh=mesh_name, mode=mode,
        n_devices=n, flops_per_device=costs.dot_flops / n,
        bytes_per_device=costs.io_bytes / n,
        collective_bytes_per_device=(
            None if n > 1 else float(sum(costs.collectives.values()))),
        collectives=dict(costs.collective_calls),
        collective_bytes_by_kind=dict(costs.collectives),
        peak_memory_per_device=peak,
        model_flops=model_flops_estimate(cfg, shape))

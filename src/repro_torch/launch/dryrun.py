"""Dry-run: the work and the least time of every step the zoo defines.

For every (architecture x input shape) pair this builds the right step's
artifacts (``launch.steps``: the train step for ``train_4k``, the forward
for ``prefill_32k``, the serve step for the decode shapes; with
``--paper-mode`` the pods-as-workers DySTop round) on the 256-device
("single": data 16 x model 16) and 512-device ("multi": pod 2 x data 16 x
model 16) production meshes or the one-device host mesh, runs the step
once on the ``meta`` device under the cost counter
(``launch.loopcost.step_costs``: no data, no card, nothing allocated), and
writes its roofline at the H100's peaks (``launch.analysis``) as one JSON
per combination under ``experiments/dryrun_torch/``.

This is the port of ``repro.launch.dryrun``, whose lower-and-compile is
replaced by the counted ``meta`` run: the JSON has the JAX package's keys
without ``memory_analysis``, ``lower_s``, ``compile_s`` and
``loop_corrections`` (no compiler, no loop to correct), plus ``trace_s``
(the counted run's wall time) and ``mesh_devices``.  The step is the same
unsharded program on every mesh, so one process counts it once per
(arch, shape) and reuses the count across meshes.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --paper-mode
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import analysis as A
from repro_torch.launch import loopcost as LC
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import registry as R
from repro_torch.optim import get_optimizer

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"
MESHES = ("single", "multi", "host")

_COSTS: dict = {}     # (arch, shape, mode, optimizer, local_steps) -> counts


def _mesh(name: str):
    if name == "host":
        return make_host_mesh("meta")
    return make_production_mesh(multi_pod=name == "multi")


def run_one(arch: str, shape_name: str, mesh_name: str,
            optimizer_name: str = "adam", paper_mode: bool = False,
            local_steps: int = 1, verbose: bool = True,
            out_dir: pathlib.Path = OUT_DIR) -> dict:
    """Count ``arch``'s step at ``shape_name`` on ``mesh_name`` ("single",
    "multi" or "host"), write its roofline JSON under ``out_dir`` and
    return it (or a record with ``"skipped"``: long_500k without a
    sub-quadratic path, or a decode shape in paper mode, whose round step
    trains)."""
    cfg = R.get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape_name == "long_500k" and not R.long_context_capable(cfg):
        return {"arch": arch, "shape": shape_name,
                "skipped": "no sub-quadratic path"}
    if paper_mode:
        if shape.mode == "decode":
            return {"arch": arch, "shape": shape_name,
                    "skipped": "the pods round trains; a decode shape has "
                               "no labels"}
        mesh_name = "multi"            # the DFL plane needs the pod axis
    mesh = _mesh(mesh_name)
    opt = get_optimizer(optimizer_name)
    if paper_mode:
        art = S.build_dystop_artifacts(cfg, shape, mesh, opt, remat=True,
                                       local_steps=local_steps)
        mode = "dystop_round"
    elif shape.mode == "train":
        art = S.build_train_artifacts(cfg, shape, mesh, opt, remat=True)
        mode = "train"
    elif shape.mode == "prefill":
        art = S.build_prefill_artifacts(cfg, shape, mesh)
        mode = "prefill"
    else:
        art = S.build_serve_artifacts(cfg, shape, mesh)
        mode = "serve"

    key = (arch, shape_name, mode, optimizer_name, local_steps)
    if key not in _COSTS:
        t0 = time.perf_counter()
        costs = LC.step_costs(art.step_fn, *art.abstract_args)
        _COSTS[key] = (costs, time.perf_counter() - t0)
    costs, trace_s = _COSTS[key]
    roof = A.extract_roofline(cfg, shape, mesh_name, mesh, mode, costs, art)
    rec = roof.to_dict()
    rec["trace_s"] = trace_s
    rec["mesh_devices"] = mesh.n_devices
    rec["optimizer"] = optimizer_name if mode in ("train",
                                                  "dystop_round") else None
    if verbose:
        t_coll = rec["t_collective"]
        print(f"--- {arch} x {shape_name} x {mesh_name} ({mode}) ---")
        print(f"counted: flops/dev={rec['flops_per_device']:.3e} "
              f"bytes/dev={rec['bytes_per_device']:.3e} "
              f"peak/dev={rec['peak_memory_per_device']:.3e} B "
              f"kernel calls {dict(costs.kernel_calls)}")
        print(f"roofline: t_comp={rec['t_compute'] * 1e3:.2f}ms "
              f"t_mem={rec['t_memory'] * 1e3:.2f}ms t_coll="
              f"{'n/a' if t_coll is None else f'{t_coll * 1e3:.2f}ms'} "
              f"bottleneck={rec['bottleneck']} "
              f"useful_flops={rec['useful_flops_ratio']:.3f} "
              f"(counted in {trace_s:.1f}s)")
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "_dystop" if paper_mode else ""
    (out_dir / f"{arch}_{shape_name}_{mesh_name}{suffix}.json").write_text(
        json.dumps(rec, indent=1))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=R.ARCH_IDS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "host"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--paper-mode", action="store_true",
                    help="count the pods-as-workers DySTop round step "
                         "(train + staleness-weighted pod aggregation)")
    args = ap.parse_args()

    archs = R.ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.paper_mode:
        meshes = ["multi"]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mesh_name in meshes:
                try:
                    rec = run_one(arch, shape_name, mesh_name,
                                  args.optimizer,
                                  paper_mode=args.paper_mode)
                    if rec.get("skipped"):
                        print(f"SKIP {arch} x {shape_name}: "
                              f"{rec['skipped']}")
                except Exception as e:    # record it, go on with the rest
                    traceback.print_exc()
                    failures.append((arch, shape_name, mesh_name, repr(e)))
            _COSTS.clear()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()

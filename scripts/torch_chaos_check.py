#!/usr/bin/env python
"""Kill-and-resume check on the PyTorch port (the twin of
``scripts/chaos_check.py``).

A child process runs a federation with periodic snapshots on the same
device (mid-scenario, so the crash lands inside a fault window); the parent
SIGKILLs it as soon as a snapshot appears, resumes from the oldest retained
snapshot, and asserts the continued run is bit-identical on the control
plane (histories, staleness, comm accounting) and f32-close on the learning
curve against an uninterrupted run.

    PYTHONPATH=src python scripts/torch_chaos_check.py [--plane sim|lm|both] \\
        [--out chaos.json] [--device cuda|cpu]

``--device`` is where the model plane runs: the card by default (it raises
without one), or ``cpu``, where the kernels' plain versions run.
Internal: ``--child <plane> --dir <ckpt_dir>`` is the killed subprocess
mode.  Exit 0 on pass, 1 on any mismatch.  Prints the JSON artifact, and
writes it to ``--out`` when given.

The comparison is kill-point-independent: wherever the SIGKILL lands, the
resumed run continues to the same ``n_rounds``, so the final histories must
match the uninterrupted run's exactly.  Resuming from the OLDEST retained
snapshot (not the newest) maximizes the replayed span under test.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

CONTROL_FIELDS = ("rounds", "sim_time", "comm_gb", "staleness_avg",
                  "staleness_max", "round_durations", "round_active")
SIM_MODEL_FIELDS = ("acc_global", "acc_local", "loss_global")
LM_MODEL_FIELDS = ("loss_global", "round_loss")

# small enough for CI smoke, large enough that the child is mid-run when the
# first snapshot (round 5) appears.  pipeline_depth=1 pinned explicitly: the
# SIGKILL lands while the async dispatch pipeline has a chunk in flight, so
# this doubles as the kill-mid-pipeline half of tests/test_pipeline.py
SIM_KW = dict(n_workers=16, n_rounds=60, n_samples=2000, dim=16,
              eval_every=10, seed=7, scenario="churn20", pipeline_depth=1)
LM_KW = dict(n_workers=6, n_rounds=20, batch=2, seq=16, eval_every=5,
             seed=7, scenario="blackout", scan_horizon=4, pipeline_depth=1)
CKPT_EVERY = 5


def _sim_run(device, ckpt_dir=None, resume_from=None):
    from repro_torch.core.baselines import get_mechanism
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    kw = dict(SIM_KW)
    if ckpt_dir is not None:
        kw.update(checkpoint_every=CKPT_EVERY, checkpoint_dir=str(ckpt_dir))
    return run_simulation(get_mechanism("dystop"), SimConfig(**kw),
                          resume_from=resume_from, device=device)


def _lm_run(device, ckpt_dir=None, resume_from=None):
    from repro_torch.core.baselines import get_mechanism
    from repro_torch.dfl.lm_worker import LMRunConfig, run_lm_federation
    from repro_torch.models import registry as R
    kw = dict(LM_KW)
    if ckpt_dir is not None:
        kw.update(checkpoint_every=CKPT_EVERY, checkpoint_dir=str(ckpt_dir))
    _, hist = run_lm_federation(get_mechanism("dystop"),
                                R.get_smoke_config("smollm-135m"),
                                LMRunConfig(**kw), resume_from=resume_from,
                                device=device)
    return hist


RUNNERS = {"sim": (_sim_run, SIM_MODEL_FIELDS),
           "lm": (_lm_run, LM_MODEL_FIELDS)}


def child_main(plane: str, ckpt_dir: str, device: str) -> None:
    RUNNERS[plane][0](device, ckpt_dir=ckpt_dir)


def kill_and_resume(plane: str, device: str) -> dict:
    """One plane's full cycle on ``device``; returns the artifact record."""
    from repro_torch.checkpoint.io import list_checkpoints
    runner, model_fields = RUNNERS[plane]
    ckpt_dir = pathlib.Path(tempfile.mkdtemp(prefix=f"torch_chaos_{plane}_"))
    rec = {"plane": plane, "device": device, "passed": False,
           "killed_mid_run": False}

    child = subprocess.Popen(
        [sys.executable, __file__, "--child", plane, "--dir", str(ckpt_dir),
         "--device", device])
    try:
        deadline = time.time() + 600
        while time.time() < deadline:
            if list_checkpoints(ckpt_dir):
                break
            if child.poll() is not None:
                break
            time.sleep(0.2)
        if child.poll() is None:
            child.kill()                      # SIGKILL: no cleanup handlers
            child.wait()
            rec["killed_mid_run"] = True
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()

    cks = list_checkpoints(ckpt_dir)
    if not cks:
        rec["error"] = "child produced no checkpoint within the deadline"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        return rec
    rec["resume_from"] = cks[0].name          # oldest retained snapshot
    print(f"[chaos:{plane}] killed={rec['killed_mid_run']}, resuming from "
          f"{cks[0].name} ({len(cks)} snapshots on disk)", flush=True)

    ref = runner(device)                      # uninterrupted reference
    res = runner(device, resume_from=str(cks[0]))   # continue the killed run

    mismatches = []
    for f in CONTROL_FIELDS:
        if getattr(ref, f) != getattr(res, f):
            mismatches.append({"field": f, "kind": "control-bitwise"})
    for f in model_fields:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(res, f))
        if a.shape != b.shape or not np.allclose(a, b, rtol=2e-5, atol=1e-7):
            mismatches.append({"field": f, "kind": "model-f32",
                               "max_rel": float(np.max(np.abs(a - b) /
                                                (np.abs(a) + 1e-12)))
                               if a.shape == b.shape else None})
    rec["mismatches"] = mismatches
    rec["passed"] = not mismatches
    rec["final_round"] = ref.rounds[-1] if ref.rounds else None
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plane", default="both", choices=["sim", "lm", "both"])
    ap.add_argument("--out", default=None, help="JSON artifact path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model plane runs (default: the card)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    from repro_torch.device import resolve_device
    device = str(resolve_device(args.device, "torch_chaos_check"))
    if args.child:
        child_main(args.child, args.dir, device)
        return 0
    planes = ["sim", "lm"] if args.plane == "both" else [args.plane]
    records = [kill_and_resume(p, device) for p in planes]
    ok = all(r["passed"] for r in records)
    artifact = {"suite": "chaos_check", "passed": ok, "records": records}
    print(json.dumps(artifact, indent=2))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(artifact, indent=2))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

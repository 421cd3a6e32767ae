#!/usr/bin/env python3
"""Phase 26's run of ``chip_smoke.py`` alone (the hybrid LM fleet:
recurrentgemma-2b at full width, 3 of 26 layers, ``HYBRID_RUN``) from the
checkout given as the argument, with its kernels built there; prints one
JSON line: the run's peak device memory, its wall (set-up included),
``loss_global`` and the card.  With a second argument ``serve`` it runs
phase 28 instead (recurrentgemma-2b served at full size) and prints its
ms a tick, peak and the device kernels of its profiled ticks; with
``train`` it runs phase 39 (``launch.train.train`` on smollm-135m) and
prints its ms a step and the device kernels of its profiled steps.

To hold two commits against each other on one card, unpack both into a
directory that ``.gitignore`` lists and run them in one call, in the order
parent, change, change, parent::

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/archive
    for t in parent archive archive parent; do
        python3 chip_hybrid_ab.py build/$t | tail -n 1; done

``python3 chip_hybrid_ab.py . cpu`` rehearses it on the CPU at the smoke
geometry (no peak).
"""
import dataclasses
import json
import os
import sys
import time


def main() -> None:
    tree = os.path.abspath(sys.argv[1])
    cpu = sys.argv[2:] == ["cpu"]
    serve = sys.argv[2:] == ["serve"]
    train = sys.argv[2:] == ["train"]
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    os.chdir(tree)
    import torch
    import chip_smoke as CS
    from repro_torch.configs import recurrentgemma_2b
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import lm_worker as LW
    from repro_torch.kernels import _build
    from repro_torch.models import registry as R

    t0 = time.perf_counter()
    if train:
        import pathlib
        _build.build()
        out, _ = CS.train_phase(pathlib.Path(tree) / "build" / "ab_train")
        print(json.dumps({
            "tree": sys.argv[1], "ms_per_step": out["ms_per_step"],
            "profiled_steps": out["profiled_steps"],
            "device_kernels": out.get("device_kernels"),
            "device_busy_share": out["device_busy_share"],
            "card": CS.nvidia_smi()}), flush=True)
        return
    if serve:
        _build.build()
        out = CS.full_serve_phase(recurrentgemma_2b.get_config(),
                                  "recurrentgemma")
        print(json.dumps({
            "tree": sys.argv[1], "ms_per_tick": out["ms_per_tick"],
            "peak_bytes": out["max_memory_allocated_bytes"],
            "device_kernels": out.get("device_kernels"),
            "profiled_ticks": out["profiled_ticks"],
            "card": CS.nvidia_smi()}), flush=True)
        return
    if cpu:
        cfg = R.get_smoke_config("recurrentgemma-2b")
        run = LW.LMRunConfig(n_workers=2, n_rounds=3, batch=1, seq=96,
                             eval_every=1)
    else:
        _build.build()
        cfg = dataclasses.replace(recurrentgemma_2b.get_config(), n_layers=3)
        run = LW.LMRunConfig(**CS.HYBRID_RUN)
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    fleet, hist = LW.run_lm_federation(
        DySTop(V=3.0, t_thre=10, max_neighbors=3), cfg, run,
        device="cpu" if cpu else "cuda")
    if not cpu:
        torch.cuda.synchronize()
    print(json.dumps({
        "tree": sys.argv[1], "build_s": t1 - t0,
        "wall_s": time.perf_counter() - t1,
        "peak_bytes": None if cpu else torch.cuda.max_memory_allocated(),
        "loss_global": [float(v) for v in hist.loss_global],
        "card": None if cpu else CS.nvidia_smi()}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the DySTop simulation plane on one card.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises, and the script exits nonzero with no result):

1. print the card's name and power limit; build both CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (N = 100 workers, P = 6,922 parameters): the Eq. 4
   ``aggregate`` over every (k, u) bucket, column-sparse (with repeated,
   zero-weighted padding columns and u = N) and row-sparse, to f32 atol and
   rtol 1e-5; the Eq. 5 ``fused_sgd`` at k in {8, 16, 100}, with losses on
   and off, to atol 1e-4 after 2 steps (the sums run in another order than
   the plain version's batched products), inactive rows bit-identical;
3. zero the launch counters, run ``run_simulation(DySTop(V=10, t_thre=20),
   SimConfig())`` at the defaults on the card, read the counters (both
   kernels must have launched) and check that accuracy rose;
4. time each kernel (CUDA events, median of 60 launches queued behind a
   device-side sleep, so the time is the card's and not the host's) beside
   its plain version, one PyTorch library call where one computes the same
   function, and its bound — the larger of the bytes it must move over
   3.35 TB/s and its flops over 67 TFLOP/s f32 — at the shapes the main path
   launched most;
5. run a 60-round copy of the config on the card and on the CPU: the
   control plane must match exactly and the accuracy curve within 1e-3
   (both runs draw identical batches);
6. run the main path once more under ``torch.profiler`` and report the
   card's kernel time and its share of phase 3's wall time.

Prints a ``{"kernels": [...]}`` line, a ``{"sim": {...}}`` line and, as the
last line, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time
from collections import Counter

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
N_WORKERS, REPS = 100, 60


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def device_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn``'s launches: each rep is queued behind a
    ~1 ms device sleep, so its launches run back to back on the card and the
    host's launch overhead stays out of the number."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def call_ms(fn, reps: int = REPS) -> float:
    """Mean wall time per call of ``fn`` called back to back from the host
    (host launch overhead included), synchronised at the end."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_profile(fn):
    """Device kernel time of ``fn`` from a ``torch.profiler`` trace: total
    seconds and the five kernels that took most, or (None, []) when the
    trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us, e.key, e.count))
    total = sum(us for us, _, _ in rows)
    if total <= 0:
        return None, []
    rows.sort(reverse=True)
    return total * 1e-6, [{"kernel": k[:80], "s": us * 1e-6, "count": c}
                          for us, k, c in rows[:5]]


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def agg_case(gen, k: int, u: int, n: int, col: bool, dev):
    """Inputs like the packer's: W rows (k, u) with the padding columns
    zeroed and their col_ids repeating 0 (u < N), or col_ids = arange(N)."""
    import torch
    if col and u < n:
        ut = max(1, (3 * u) // 4)
        cols = torch.sort(torch.randperm(n, generator=gen)[:ut]).values
        col_ids = torch.cat([cols, torch.zeros(u - ut, dtype=cols.dtype)])
        W = torch.rand((k, u), generator=gen)
        W[:, ut:] = 0.0
    elif col:
        col_ids = torch.arange(n)
        W = torch.rand((k, n), generator=gen)
    else:
        col_ids = None
        W = torch.rand((k, n), generator=gen)
    W = W / W.sum(1, keepdim=True)
    cid = None if col_ids is None else col_ids.to(torch.int32).to(dev)
    return W.to(dev), cid


def agg_cost(k, W, col_ids, p, n):
    distinct = n if col_ids is None else len(set(col_ids.tolist()))
    nz_cols = int((W != 0).any(0).sum())
    nbytes = (distinct * p + k * p + W.numel()) * 4 \
        + (0 if col_ids is None else col_ids.numel() * 4)
    return bound(nbytes, 2.0 * k * nz_cols * p)


def sgd_case(gen, k, steps, batch, dim, classes, dev, p):
    import torch
    buf = torch.randn((k, p), generator=gen) * 0.2
    xb = torch.randn((k, steps, batch, dim), generator=gen)
    yb = torch.randint(0, classes, (k, steps, batch), generator=gen,
                       dtype=torch.int32)
    active = (torch.arange(k) % 4 != 3).float()     # a quarter idle
    return buf.to(dev), xb.to(dev), yb.to(dev), active.to(dev)


def sgd_cost(spec, active, k, steps, batch, with_losses):
    shp = dict(zip(spec.keys, spec.shapes))
    (d, h), (_, g), (_, c) = shp["w1"], shp["w2"], shp["w3"]
    n_act = int((active != 0).sum())
    per_fwd = 2.0 * batch * (d * h + h * g + g * c)
    per_step = 2.0 * batch * (2 * d * h + 3 * h * g + 3 * g * c)
    flops = steps * (n_act * per_step
                     + (k - n_act) * (per_fwd if with_losses else 0.0))
    needs_batch = n_act if not with_losses else k
    nbytes = (2 * k * spec.n_params + 2 * k
              + needs_batch * steps * batch * (d + 1)) * 4
    return bound(nbytes, flops)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import flat_state as FS
    from repro_torch.dfl import worker as WK
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    from repro_torch.kernels import _build
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import fused_sgd as FSGD

    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE f32 everywhere
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    cfg = SimConfig()
    spec = FS.spec_of(WK.init_stacked(torch.Generator(), 1, cfg.dim,
                                      cfg.hidden, 10))
    P = spec.n_params
    gen = torch.Generator().manual_seed(1234)

    # ---- 2. each kernel against its plain version --------------------------
    buckets = (8, 16, 32, 64, N_WORKERS)
    X = torch.randn((N_WORKERS, P), generator=gen).to(dev)
    agg_err = 0.0
    for k in buckets:
        cases = [(u, True) for u in buckets] + [(N_WORKERS, False)]
        for u, col in cases:
            W, cid = agg_case(gen, k, u, N_WORKERS, col, dev)
            got = AGG.aggregate(W, X, cid)
            want = AGG.aggregate_plain(W, X, cid)
            torch.cuda.synchronize()
            agg_err = max(agg_err, float((got - want).abs().max()))
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    print(f"aggregate: {len(buckets) * 6} bucket cases match the plain "
          f"version, max |err| {agg_err:.3e}", flush=True)

    sgd_err = 0.0
    steps, batch = cfg.local_steps, cfg.batch_size
    for k in (8, 16, N_WORKERS):
        for with_losses in (True, False):
            buf, xb, yb, active = sgd_case(gen, k, steps, batch,
                                           cfg.dim, 10, dev, P)
            out, loss = FSGD.fused_sgd(buf, xb, yb, active, spec, cfg.lr,
                                       with_losses=with_losses)
            ref, ref_loss = FSGD.local_sgd_flat_fused(
                buf, xb, yb, active, spec, cfg.lr, with_losses=with_losses)
            torch.cuda.synchronize()
            sgd_err = max(sgd_err, float((out - ref).abs().max()),
                          float((loss - ref_loss).abs().max()))
            torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
            torch.testing.assert_close(loss, ref_loss, atol=1e-4, rtol=0)
            idle = active == 0
            check(torch.equal(out[idle], buf[idle]),
                  "fused_sgd changed an inactive row")
            check(with_losses or torch.equal(loss, torch.zeros_like(loss)),
                  "fused_sgd reported losses with with_losses=False")
    print(f"fused_sgd: 6 cases match the plain version, max |err| "
          f"{sgd_err:.3e}", flush=True)

    # ---- 3. the main path, through the kernels -----------------------------
    shapes: Counter = Counter()
    orig_agg, orig_sgd = AGG.aggregate, FSGD.fused_sgd

    def rec_agg(W, X, col_ids=None, **kw):
        shapes[("aggregate", W.shape[0], W.shape[1], col_ids is not None)] += 1
        return orig_agg(W, X, col_ids, **kw)

    def rec_sgd(buf, xb, yb, active, spec, lr, with_losses=True):
        shapes[("fused_sgd", buf.shape[0], bool(with_losses))] += 1
        return orig_sgd(buf, xb, yb, active, spec, lr, with_losses)

    AGG.aggregate, FSGD.fused_sgd = rec_agg, rec_sgd
    AGG.launches = 0
    FSGD.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        hist = run_simulation(DySTop(V=10.0, t_thre=20), cfg)
    finally:
        AGG.aggregate, FSGD.fused_sgd = orig_agg, orig_sgd
    torch.cuda.synchronize()
    sim_wall = time.perf_counter() - t0
    launches = {"aggregate": AGG.launches, "fused_sgd": FSGD.launches}
    check(launches["aggregate"] > 0 and launches["fused_sgd"] > 0,
          f"a kernel of the main path never launched: {launches}")
    acc = np.asarray(hist.acc_global)
    check(np.isfinite(acc).all() and np.isfinite(hist.loss_global).all(),
          "non-finite accuracy or loss")
    check(acc[-1] > acc[0], f"accuracy did not rise: {acc.tolist()}")
    print(f"main path: {hist.rounds[-1]} rounds in {sim_wall:.2f} s, "
          f"launches {launches}, acc {acc[0]:.4f} -> {acc[-1]:.4f}",
          flush=True)

    # ---- 4. times at the main path's shapes --------------------------------
    def agg_row(k, u, col, count):
        W, cid = agg_case(gen, k, u, N_WORKERS, col, dev)
        lib_cid = None if cid is None else cid.long()
        b_ms, b_by = agg_cost(k, W.cpu(), None if cid is None else cid.cpu(),
                              P, N_WORKERS)
        return {
            "k": k, "u": u, "col_sparse": col, "rounds": count,
            "ms": device_ms(lambda: AGG.aggregate(W, X, cid)),
            "plain_ms": device_ms(lambda: AGG.aggregate_plain(W, X, cid)),
            "library_ms": device_ms(
                (lambda: torch.matmul(W, X)) if cid is None else
                (lambda: torch.matmul(W, X.index_select(0, lib_cid)))),
            "call_ms": call_ms(lambda: AGG.aggregate(W, X, cid)),
            "bound_ms": b_ms, "bound_by": b_by}

    agg_shapes = sorted(((s, c) for s, c in shapes.items()
                         if s[0] == "aggregate"), key=lambda sc: -sc[1])
    agg_rows = [agg_row(s[1], s[2], s[3], c) for s, c in agg_shapes]
    sgd_shapes = sorted(((s, c) for s, c in shapes.items()
                         if s[0] == "fused_sgd"), key=lambda sc: -sc[1])
    sgd_rows = []
    for s, c in sgd_shapes:
        k, with_losses = s[1], s[2]
        buf, xb, yb, active = sgd_case(gen, k, steps, batch, cfg.dim,
                                       10, dev, P)
        b_ms, b_by = sgd_cost(spec, active, k, steps, batch, with_losses)
        sgd_rows.append({
            "k": k, "with_losses": with_losses, "rounds": c,
            "ms": device_ms(lambda: FSGD.fused_sgd(
                buf, xb, yb, active, spec, cfg.lr, with_losses)),
            "plain_ms": device_ms(lambda: FSGD.local_sgd_flat_fused(
                buf, xb, yb, active, spec, cfg.lr, with_losses)),
            "call_ms": call_ms(lambda: FSGD.fused_sgd(
                buf, xb, yb, active, spec, cfg.lr, with_losses)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # ---- 5. the card and the CPU agree --------------------------------------
    short = SimConfig(n_rounds=60)
    h_card = run_simulation(DySTop(V=10.0, t_thre=20), short)
    h_cpu = run_simulation(DySTop(V=10.0, t_thre=20), short, device="cpu")
    for f in ("rounds", "sim_time", "comm_gb", "round_active",
              "staleness_avg", "staleness_max"):
        check(getattr(h_card, f) == getattr(h_cpu, f),
              f"card and CPU runs differ in {f}")
    acc_gap = float(np.max(np.abs(np.asarray(h_card.acc_global)
                                  - np.asarray(h_cpu.acc_global))))
    check(acc_gap <= 1e-3, f"card and CPU accuracy differ by {acc_gap}")
    print(f"card vs CPU, {short.n_rounds} rounds: control plane identical, "
          f"max |acc gap| {acc_gap:.2e}", flush=True)

    # ---- 6. how busy the card is on the main path --------------------------
    busy_s, busy_top = device_profile(
        lambda: run_simulation(DySTop(V=10.0, t_thre=20), cfg))
    print(f"main path under the profiler: device kernels "
          f"{busy_s if busy_s is None else round(busy_s, 4)} s", flush=True)

    top_agg, top_sgd = agg_rows[0], sgd_rows[0]
    kernels = [
        {"name": "aggregate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/aggregate.cu",
         "replaces": "src/repro/kernels/aggregate.py:210",
         "launches": launches["aggregate"], "max_abs_err": agg_err,
         "shape": {k: top_agg[k] for k in ("k", "u", "col_sparse")},
         "ms": top_agg["ms"], "kernel_ms": top_agg["ms"],
         "plain_ms": top_agg["plain_ms"], "bound_ms": top_agg["bound_ms"],
         "bound_by": top_agg["bound_by"],
         "library_ms": top_agg["library_ms"], "call_ms": top_agg["call_ms"]},
        {"name": "fused_sgd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_sgd.cu",
         "replaces": "src/repro/kernels/fused_sgd.py:95",
         "launches": launches["fused_sgd"], "max_abs_err": sgd_err,
         "shape": {k: top_sgd[k] for k in ("k", "with_losses")},
         "ms": top_sgd["ms"], "kernel_ms": top_sgd["ms"],
         "plain_ms": top_sgd["plain_ms"], "bound_ms": top_sgd["bound_ms"],
         "bound_by": top_sgd["bound_by"], "library_ms": None,
         "call_ms": top_sgd["call_ms"]},
    ]
    print(json.dumps({"aggregate_shapes": agg_rows}))
    print(json.dumps({"fused_sgd_shapes": sgd_rows}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"sim": {
        "config": "SimConfig() defaults, DySTop(V=10.0, t_thre=20)",
        "rounds": hist.rounds[-1], "evals": len(hist.rounds),
        "wall_s": sim_wall, "setup_wall_s": hist.setup_wall_s,
        "plan_wall_s": hist.plan_wall_s, "pack_wall_s": hist.pack_wall_s,
        "stage_wall_s": hist.stage_wall_s, "drain_wall_s": hist.drain_wall_s,
        "eval_wall_s": hist.eval_wall_s, "acc_first": float(acc[0]),
        "acc_final": float(acc[-1]), "sim_time_s": hist.sim_time[-1],
        "comm_gb": hist.comm_gb[-1], "card_vs_cpu_acc_gap": acc_gap,
        "device_busy_s": busy_s,
        "device_busy_share": None if busy_s is None else busy_s / sim_wall,
        "device_top_kernels": busy_top}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

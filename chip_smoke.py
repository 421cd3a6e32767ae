#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DySTop on one card: the simulation plane
and the LM fleet over two model families (dense: smollm-135m; ssm:
mamba2-2.7b).

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises, and the script exits nonzero with no result):

1. print the card's name and power limit; build the four CUDA kernels from
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
   card's kernel time and its share of phase 3's wall time;
7. hold the flash-attention kernel against its plain version on the card,
   in bf16 and f32: the LM path's shape (4, 9, 256, 64) causal with 3 kv
   heads, a ragged S = 200, window 64, softcap 50, (1, 8, 1024, 128), and
   window 0 (every row fully masked, the first rows included) beside a
   non-causal window of -32 (the last 33 rows fully masked) — f32 to 1e-5
   absolute, bf16 to 2 bf16 ulps of the larger magnitude after 1e-6 of f32
   sum-order noise;
8. zero the launch counters, run the LM fleet's main path at full width —
   ``run_lm_federation(DySTop(V=3.0, t_thre=10, max_neighbors=3),
   smollm_135m.get_config(), LMRunConfig(n_workers=8, n_rounds=30,
   batch=4, seq=256, optimizer="adam", lr=1e-3, eval_every=5))``, all 30
   layers, as ``examples/dfl_lm.py`` runs it except ``seq=256`` for its 64,
   so each row's attention spans four of the kernel's 64-row kv tiles — read
   the counters (flash_attention and aggregate must have launched) and
   check the evals are finite;
9. at the LM path's commonest shapes, hold each kernel against its plain
   version once more and time it: flash on the model's strided q/k/v views
   (2 bf16 ulps) beside its plain version,
   ``scaled_dot_product_attention(is_causal=True)`` and its bound (bytes
   over 3.35 TB/s against flops over the peak for the inputs' type, 989
   TFLOP/s bf16 or 67 TFLOP/s f32); aggregate over the fleet's real (8, P)
   buffer (f32 atol and rtol 1e-5) beside its plain version, ``matmul``
   and its bound; then, the fleet freed, profile a 10-round copy of phase
   8: the card's kernel time over that copy's own round-loop wall (its
   ``wall_s`` less its ``setup_wall_s``) is the busy share;
10. run the smoke geometry of smollm-135m for 9 rounds with 4 workers (two
   rounds train 3 and 4 rows) on the card and on the CPU: the control plane
   must match exactly and ``loss_global`` within 2e-2 (bf16 activations
   round in other kernels on the two devices, and Adam steps the rounded
   parameters);
11. hold the ``ssd_chunk`` kernel against its plain version on the card,
   with TF32 off, to atol and rtol 2e-4 (the JAX package's own kernel
   tolerance), outputs finite: the mamba2 path's shape (G, H, Q, N, P) =
   (8, 80, 256, 128, 64) on the model's head-major views, the smoke shape,
   a ragged Q = 200, and a large ``dt`` whose masked exponents pass 88;
12. zero the launch counters, run the LM fleet on mamba2-2.7b at full width
   and 8 of its 64 layers — ``run_lm_federation(DySTop(V=3.0, t_thre=10,
   max_neighbors=3), replace(mamba2_2_7b.get_config(), n_layers=8),
   LMRunConfig(n_workers=8, n_rounds=30, batch=4, seq=512,
   optimizer="adam", lr=1e-3, eval_every=5))``, two 256-step chunks per
   row — read the counters (ssd_chunk and aggregate must have launched,
   flash_attention must not), check the evals, parameters and optimizer
   state are finite, record the largest masked exponent the path met, hold
   ``aggregate`` against its plain version on the fleet's (8, P) buffer,
   and profile a 10-round copy for the busy share as in phase 9;
13. time ``ssd_chunk`` at the path's commonest shape beside its plain
   version and its bound (no single PyTorch call computes it);
14. run the mamba2 smoke geometry for 9 rounds with 4 workers (seq 64 over
   chunk 32) on the card and on the CPU: control plane identical,
   ``loss_global`` within 2e-2.

Prints ``{"aggregate_shapes"}``, ``{"fused_sgd_shapes"}``, ``{"lm": ...}``,
``{"mamba2": ...}``, ``{"kernels": [...]}`` and ``{"sim": {...}}`` lines,
the card's name and power limit and, as the last line, ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time
from collections import Counter

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12                # H100 SXM bf16 tensor cores, dense
N_WORKERS, REPS = 100, 60
LM_CARD_CPU_TOL = 2e-2             # loss_global, card vs CPU, bf16 smoke run


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
    trace holds no device time; and the trace's device kernel count with
    the eight host ops that took most host time of their own."""
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
    host = sorted(((e.self_cpu_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), reverse=True)
    extra = {"device_kernels": sum(c for _, _, c in rows),
             "host_top_ops": [{"op": k[:60], "self_s": us * 1e-6, "count": c}
                              for us, k, c in host[:8]]}
    if total <= 0:
        return None, [], extra
    rows.sort(reverse=True)
    return total * 1e-6, [{"kernel": k[:80], "s": us * 1e-6, "count": c}
                          for us, k, c in rows[:5]], extra


def all_finite(buf) -> bool:
    """Whether every value of an (N, P) buffer is finite, one row at a time:
    ``torch.isfinite`` makes a temporary as large as its input (an f32
    ``abs``), too much beside a 43 GB fleet."""
    import torch
    return all(bool(torch.isfinite(row).all()) for row in buf)


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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


def flash_mask(s: int, causal: bool, window):
    import torch
    rows = torch.arange(s)[:, None]
    cols = torch.arange(s)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= (rows - cols) < window
    return mask


def flash_cost(q, k, causal, window):
    """Bytes: q, k, v (as passed, kv heads once) read and o written once.
    Flops: 4 D per unmasked (row, column) pair, over the peak for the
    inputs' type."""
    import torch
    b, h, s, d = q.shape
    pairs = int(flash_mask(s, causal, window).sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    rate = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    return bound(nbytes, 4.0 * d * pairs * b * h, rate)


def bf16_ulps(got, want, f32_atol: float = 1e-6) -> float:
    """Largest distance in bf16 ulps of the larger magnitude, after
    ``f32_atol`` of f32 sum-order noise (which near 0 is itself several bf16
    ulps of the tiny value)."""
    import torch
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() - f32_atol).clamp_min(0).div(ulp).max())


def ssd_case(gen, g, h, q, n, p, rate, dev):
    """Inputs as ``ssm_forward`` hands them over: Bc, Cc (G, Q, N); cum_la a
    cumulative sum of negative log decays, ``rate`` per step on average,
    and xbar, both as head-major views of (G, Q, H, .) tensors."""
    import torch
    Bc = torch.randn((g, q, n), generator=gen)
    Cc = torch.randn((g, q, n), generator=gen)
    step = torch.nn.functional.softplus(torch.randn((g, q, h), generator=gen))
    la = -torch.cumsum(step * rate, dim=1)
    xb = torch.randn((g, q, h, p), generator=gen)
    return (Bc.to(dev), Cc.to(dev), la.to(dev).transpose(1, 2),
            xb.to(dev).transpose(1, 2))


def ssd_cost(g, h, q, n, p):
    """Bytes: Bc, Cc, cum_la and xbar read once, y written once (f32).
    Flops: for each causal (q, t) pair of each chunk, 2 N for the score and
    H * 2 P for the products, over the f32 CUDA-core peak."""
    pairs = q * (q + 1) // 2
    nbytes = 4 * (2 * g * q * n + g * h * q + 2 * g * h * q * p)
    return bound(nbytes, float(g) * pairs * (2 * n + 2 * h * p))


def recorder(counter, agg, fa=None):
    """Wrappers around the kernels' entry points that count each call's
    shape (the kernels' own launch counters stay the only proof of
    launches)."""
    def rec_agg(W, X, col_ids=None, **kw):
        counter[("aggregate", W.shape[0], W.shape[1],
                 col_ids is not None)] += 1
        return agg(W, X, col_ids, **kw)

    def rec_fa(q, k, v, causal=True, window=None, softcap=None):
        counter[("flash_attention", tuple(q.shape), k.shape[1], q.dtype,
                 causal, window, softcap)] += 1
        return fa(q, k, v, causal, window, softcap)

    return rec_agg, rec_fa


def ssd_recorder(counter, exponents, ssd):
    """A wrapper around ``ssd_chunk`` that counts each call's shape and
    keeps, on the card and without a sync, the largest masked exponent
    la_0 - la_{Q-1} of the call (la falls along the chunk, so it is the
    largest la_q - la_t over t > q: what an exp-before-mask form would
    evaluate)."""
    def rec_ssd(Bc, Cc, cum_la, xbar):
        g, h, q, p = xbar.shape
        counter[("ssd_chunk", g, h, q, Bc.shape[2], p)] += 1
        exponents.append((cum_la[..., 0] - cum_la[..., -1]).detach().max())
        return ssd(Bc, Cc, cum_la, xbar)

    return rec_ssd


def lm_aggregate_row(gen, shapes, launches: int, buf, label: str) -> dict:
    """Hold ``aggregate`` against its plain version on an LM fleet's real
    (N, P) buffer at the path's commonest mix shape (f32 atol and rtol
    1e-5), and time it beside its plain version, ``matmul`` and its bound
    (median of 10 launches: each moves GBs)."""
    import torch
    from repro_torch.kernels import aggregate as AGG
    (_, k, u, col), count = max(((s, c) for s, c in shapes.items()
                                 if s[0] == "aggregate"), key=lambda sc: sc[1])
    n, p = buf.shape
    W, cid = agg_case(gen, k, u, n, col, buf.device)
    b_ms, b_by = agg_cost(k, W.cpu(), None if cid is None else cid.cpu(), p,
                          n)
    got = AGG.aggregate(W, buf, cid)
    want = AGG.aggregate_plain(W, buf, cid)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    del got, want
    print(f"aggregate at the {label} shape (k={k}, u={u}, P={p}) on the "
          f"fleet's buffer: max |err| {err:.3e}", flush=True)
    lib_cid = None if cid is None else cid.long()
    return {
        "k": k, "u": u, "col_sparse": col, "P": p, "rounds": count,
        "launches": launches, "max_abs_err": err,
        "ms": device_ms(lambda: AGG.aggregate(W, buf, cid), reps=10),
        "plain_ms": device_ms(lambda: AGG.aggregate_plain(W, buf, cid),
                              reps=10),
        "library_ms": device_ms(
            (lambda: torch.matmul(W, buf)) if cid is None else
            (lambda: torch.matmul(W, buf.index_select(0, lib_cid))), reps=10),
        "bound_ms": b_ms, "bound_by": b_by}


def lm_profile(mech, cfg, run) -> dict:
    """Profile a 10-round copy of an LM run: the card's kernel time over the
    copy's own round loop (its ``wall_s`` less its ``setup_wall_s``) is the
    busy share."""
    from repro_torch.dfl import lm_worker as LW
    short = dataclasses.replace(run, n_rounds=10)
    hist = []
    busy_s, top, extra = device_profile(
        lambda: hist.append(LW.run_lm_federation(mech, cfg, short)[1]))
    loop_wall = hist[0].wall_s - hist[0].setup_wall_s
    return {"profiled_rounds": short.n_rounds,
            "profiled_run_wall_s": hist[0].wall_s,
            "profiled_setup_wall_s": hist[0].setup_wall_s,
            "device_busy_s": busy_s,
            "device_busy_share": (None if busy_s is None
                                  else busy_s / loop_wall),
            "device_top_kernels": top, **extra}


def lm_card_vs_cpu(mech, cfg, label: str) -> float:
    """Run ``cfg`` for 9 rounds with 4 workers on the card and on the CPU:
    the control plane must match exactly and ``loss_global`` within
    ``LM_CARD_CPU_TOL``.  Returns the largest loss gap."""
    import numpy as np
    from repro_torch.dfl import lm_worker as LW
    run = LW.LMRunConfig(n_workers=4, n_rounds=9, batch=2, seq=64,
                         eval_every=3, seed=1)
    _, card = LW.run_lm_federation(mech(), cfg, run)
    _, cpu = LW.run_lm_federation(mech(), cfg, run, device="cpu")
    for f in ("rounds", "sim_time", "comm_gb", "round_active",
              "round_durations", "staleness_avg", "staleness_max"):
        check(getattr(card, f) == getattr(cpu, f),
              f"{label} card and CPU runs differ in {f}")
    gap = float(np.max(np.abs(np.asarray(card.loss_global)
                              - np.asarray(cpu.loss_global))))
    check(gap <= LM_CARD_CPU_TOL,
          f"{label} card and CPU loss_global differ by {gap}")
    print(f"{label} card vs CPU, {run.n_rounds} rounds: control plane "
          f"identical, max |loss_global gap| {gap:.2e}", flush=True)
    return gap


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
    from repro_torch.configs import mamba2_2_7b, smollm_135m
    from repro_torch.dfl import lm_worker as LW
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_sgd as FSGD
    from repro_torch.kernels import ssd_chunk as SC

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
    orig_fa = FA.flash_attention
    rec_agg, _ = recorder(shapes, orig_agg)

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
    busy_s, busy_top, _ = device_profile(
        lambda: run_simulation(DySTop(V=10.0, t_thre=20), cfg))
    print(f"main path under the profiler: device kernels "
          f"{busy_s if busy_s is None else round(busy_s, 4)} s", flush=True)

    # ---- 7. the flash kernel against its plain version --------------------
    flash_err = flash_ulps = 0.0
    fa_cases = [("path", (4, 9, 256, 64), 3, True, None, None),
                ("ragged S=200", (4, 9, 200, 64), 3, True, None, None),
                ("window 64", (4, 9, 256, 64), 3, True, 64, None),
                ("softcap 50", (4, 9, 256, 64), 3, True, None, 50.0),
                ("(1, 8, 1024, 128)", (1, 8, 1024, 128), 8, True, None, None),
                ("window 0: all rows masked", (2, 4, 96, 64), 2, True, 0,
                 None),
                ("non-causal window -32: last rows masked", (2, 4, 160, 64),
                 2, False, -32, None)]
    for label, (b, h, s, d), hk, causal, window, softcap in fa_cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, s, h, d), generator=gen).to(dev, dtype)
            q = q.transpose(1, 2)          # the model's layout, as a view
            k = torch.randn((b, hk, s, d), generator=gen).to(dev, dtype)
            v = torch.randn((b, hk, s, d), generator=gen).to(dev, dtype)
            got = FA.flash_attention(q, k, v, causal, window, softcap)
            want = FA.flash_attention_plain(q, k, v, causal, window, softcap)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all(), f"flash {label}: non-finite")
            err = float((got.float() - want.float()).abs().max())
            flash_err = max(flash_err, err)
            if dtype == torch.float32:
                check(err <= 1e-5, f"flash {label} f32: |err| {err}")
                print(f"flash {label} f32: max |err| {err:.3e}")
            else:
                ulps = bf16_ulps(got.float(), want.float())
                flash_ulps = max(flash_ulps, ulps)
                check(ulps <= 2.0, f"flash {label} bf16: {ulps} ulps")
                print(f"flash {label} bf16: max |err| {err:.3e}, "
                      f"{ulps:.2f} bf16 ulps")
            if window is not None and window <= 0:
                rows = ~flash_mask(s, causal, window).any(1)
                check(bool((got[:, :, rows.to(dev)] == 0).all()),
                      f"flash {label}: a fully masked row is not 0")
    sys.stdout.flush()

    # ---- 8. the LM fleet's main path at full width, through the kernels ----
    lm_cfg = smollm_135m.get_config()
    lm_run = LW.LMRunConfig(n_workers=8, n_rounds=30, batch=4, seq=256,
                            optimizer="adam", lr=1e-3, eval_every=5)

    def lm_mech():
        return DySTop(V=3.0, t_thre=10, max_neighbors=3)

    lm_shapes: Counter = Counter()
    AGG.aggregate, FA.flash_attention = recorder(lm_shapes, orig_agg, orig_fa)
    AGG.launches = 0
    FA.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        fleet, lm_hist = LW.run_lm_federation(lm_mech(), lm_cfg, lm_run)
    finally:
        AGG.aggregate, FA.flash_attention = orig_agg, orig_fa
    torch.cuda.synchronize()
    lm_wall = time.perf_counter() - t0
    lm_launches = {"flash_attention": FA.launches, "aggregate": AGG.launches}
    check(lm_launches["flash_attention"] > 0 and lm_launches["aggregate"] > 0,
          f"a kernel of the LM path never launched: {lm_launches}")
    lm_peak = torch.cuda.max_memory_allocated()
    lossg = np.asarray(lm_hist.loss_global)
    check(lossg.shape == (6,) and np.isfinite(lossg).all()
          and np.isfinite(lm_hist.round_loss).all(),
          f"LM evals not finite: {lossg.tolist()}")
    check(all_finite(fleet.pbuf), "LM params not finite")
    print(f"LM path: {lm_hist.rounds[-1]} rounds in {lm_wall:.2f} s, "
          f"launches {lm_launches}, loss_global {lossg[0]:.4f} -> "
          f"{lossg[-1]:.4f}", flush=True)

    # ---- 9. times at the LM path's shapes ----------------------------------
    fa_key, fa_count = max(((s, c) for s, c in lm_shapes.items()
                            if s[0] == "flash_attention"),
                           key=lambda sc: sc[1])
    _, (b, h, s, d), hk, fdt, causal, window, softcap = fa_key
    q = torch.randn((b, s, h, d), generator=gen).to(dev, fdt).transpose(1, 2)
    k = torch.randn((b, s, hk, d), generator=gen).to(dev, fdt).transpose(1, 2)
    v = torch.randn((b, s, hk, d), generator=gen).to(dev, fdt).transpose(1, 2)
    got = FA.flash_attention(q, k, v, causal, window, softcap)
    want = FA.flash_attention_plain(q, k, v, causal, window, softcap)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ulps = (bf16_ulps(got.float(), want.float()) if fdt == torch.bfloat16
            else 0.0)
    check(torch.isfinite(got).all() and ulps <= 2.0
          and (fdt == torch.bfloat16 or err <= 1e-5),
          f"flash at the LM path's strided views: |err| {err}, {ulps} ulps")
    flash_err, flash_ulps = max(flash_err, err), max(flash_ulps, ulps)
    print(f"flash at the LM path's strided q/k/v views: max |err| "
          f"{err:.3e}, {ulps:.2f} bf16 ulps", flush=True)
    k_rep = k.repeat_interleave(h // hk, dim=1)
    v_rep = v.repeat_interleave(h // hk, dim=1)
    fb_ms, fb_by = flash_cost(q, k, causal, window)
    flash_row = {
        "shape": [b, h, s, d], "kv_heads": hk, "dtype": str(fdt),
        "causal": causal, "calls": fa_count,
        "ms": device_ms(lambda: FA.flash_attention(q, k, v, causal, window,
                                                   softcap)),
        "plain_ms": device_ms(lambda: FA.flash_attention_plain(
            q, k, v, causal, window, softcap)),
        "library_ms": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_rep, v_rep, is_causal=causal)),
        "call_ms": call_ms(lambda: FA.flash_attention(q, k, v, causal,
                                                      window, softcap)),
        "bound_ms": fb_ms, "bound_by": fb_by}
    lm_agg_row = lm_aggregate_row(gen, lm_shapes, lm_launches["aggregate"],
                                  fleet.pbuf, "LM")
    agg_err = max(agg_err, lm_agg_row["max_abs_err"])
    del fleet
    torch.cuda.empty_cache()
    lm_busy = lm_profile(lm_mech(), lm_cfg, lm_run)

    # ---- 10. the card and the CPU agree on the LM plane --------------------
    lm_gap = lm_card_vs_cpu(lm_mech, smollm_135m.get_smoke_config(), "LM")

    # ---- 11. the ssd_chunk kernel against its plain version ---------------
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the plain versions must run IEEE f32 products")
    ssd_err = 0.0
    ssd_cases = [("path (8, 80, 256, 128, 64)", (8, 80, 256, 128, 64), 0.1),
                 ("smoke (4, 16, 32, 32, 32)", (4, 16, 32, 32, 32), 0.1),
                 ("ragged Q=200", (2, 8, 200, 128, 64), 0.1),
                 ("large dt: masked exponents past 88", (2, 8, 256, 128, 64),
                  2.0)]
    for label, (g_, h_, q_, n_, p_), rate in ssd_cases:
        ins = ssd_case(gen, g_, h_, q_, n_, p_, rate, dev)
        if rate > 1.0:
            top = float((ins[2][..., 0] - ins[2][..., -1]).max())
            check(top > 88.0, f"ssd {label}: largest masked exponent {top}")
        got = SC.ssd_chunk(*ins)
        want = SC.ssd_chunk_plain(*ins)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"ssd {label}: non-finite")
        err = float((got - want).abs().max())
        ssd_err = max(ssd_err, err)
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
        print(f"ssd_chunk {label}: max |err| {err:.3e}", flush=True)
    del ins, got, want

    # ---- 12. the mamba2 LM path at full width, through the kernels --------
    m_cfg = dataclasses.replace(mamba2_2_7b.get_config(), n_layers=8)
    m_run = LW.LMRunConfig(n_workers=8, n_rounds=30, batch=4, seq=512,
                           optimizer="adam", lr=1e-3, eval_every=5)
    m_shapes: Counter = Counter()
    exponents = []
    orig_ssd = SC.ssd_chunk
    AGG.aggregate, _ = recorder(m_shapes, orig_agg)
    SC.ssd_chunk = ssd_recorder(m_shapes, exponents, orig_ssd)
    AGG.launches = 0
    FA.launches = 0
    SC.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        m_fleet, m_hist = LW.run_lm_federation(lm_mech(), m_cfg, m_run)
    finally:
        AGG.aggregate, SC.ssd_chunk = orig_agg, orig_ssd
    torch.cuda.synchronize()
    m_wall = time.perf_counter() - t0
    m_launches = {"ssd_chunk": SC.launches, "aggregate": AGG.launches,
                  "flash_attention": FA.launches}
    check(m_launches["ssd_chunk"] > 0 and m_launches["aggregate"] > 0,
          f"a kernel of the mamba2 path never launched: {m_launches}")
    check(m_launches["flash_attention"] == 0,
          f"mamba2 has no attention, yet flash launched: {m_launches}")
    m_peak = torch.cuda.max_memory_allocated()
    m_expo = float(torch.stack(exponents).max())
    m_loss = np.asarray(m_hist.loss_global)
    check(m_loss.shape == (6,) and np.isfinite(m_loss).all()
          and np.isfinite(m_hist.round_loss).all(),
          f"mamba2 evals not finite: {m_loss.tolist()}")
    check(all_finite(m_fleet.pbuf) and all_finite(m_fleet.obuf),
          "mamba2 params or optimizer state not finite")
    p_m = m_fleet.pbuf.shape[1]
    print(f"mamba2 path (8 layers, P={p_m}): {m_hist.rounds[-1]} rounds in "
          f"{m_wall:.2f} s, launches {m_launches}, loss_global "
          f"{m_loss[0]:.4f} -> {m_loss[-1]:.4f}, peak "
          f"{m_peak / 1e9:.2f} GB, largest masked exponent {m_expo:.1f}",
          flush=True)
    m_agg_row = lm_aggregate_row(gen, m_shapes, m_launches["aggregate"],
                                 m_fleet.pbuf, "mamba2")
    agg_err = max(agg_err, m_agg_row["max_abs_err"])
    del m_fleet
    torch.cuda.empty_cache()
    m_busy = lm_profile(lm_mech(), m_cfg, m_run)
    torch.cuda.empty_cache()

    # ---- 13. ssd_chunk timed at the path's commonest shape ----------------
    ssd_key, ssd_count = max(((s_, c) for s_, c in m_shapes.items()
                              if s_[0] == "ssd_chunk"), key=lambda sc: sc[1])
    _, g_, h_, q_, n_, p_ = ssd_key
    ins = ssd_case(gen, g_, h_, q_, n_, p_, 0.1, dev)
    sb_ms, sb_by = ssd_cost(g_, h_, q_, n_, p_)
    ssd_row = {
        "shape": [g_, h_, q_, n_, p_], "calls": ssd_count,
        "ms": device_ms(lambda: SC.ssd_chunk(*ins)),
        "plain_ms": device_ms(lambda: SC.ssd_chunk_plain(*ins)),
        "call_ms": call_ms(lambda: SC.ssd_chunk(*ins)),
        "bound_ms": sb_ms, "bound_by": sb_by, "library_ms": None}
    del ins
    print(f"ssd_chunk at {ssd_row['shape']}: {ssd_row['ms']:.4f} ms, plain "
          f"{ssd_row['plain_ms']:.4f} ms, bound {sb_ms:.4f} ms ({sb_by})",
          flush=True)

    # ---- 14. the card and the CPU agree on the mamba2 smoke geometry -------
    m_gap = lm_card_vs_cpu(lm_mech, mamba2_2_7b.get_smoke_config(), "mamba2")

    top_agg, top_sgd = agg_rows[0], sgd_rows[0]
    kernels = [
        {"name": "aggregate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/aggregate.cu",
         "replaces": "src/repro/kernels/aggregate.py:220",
         "launches": launches["aggregate"], "max_abs_err": agg_err,
         "shape": {k: top_agg[k] for k in ("k", "u", "col_sparse")},
         "ms": top_agg["ms"], "kernel_ms": top_agg["ms"],
         "plain_ms": top_agg["plain_ms"], "bound_ms": top_agg["bound_ms"],
         "bound_by": top_agg["bound_by"],
         "library_ms": top_agg["library_ms"], "call_ms": top_agg["call_ms"],
         "lm": lm_agg_row},
        {"name": "fused_sgd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_sgd.cu",
         "replaces": "src/repro/kernels/fused_sgd.py:112",
         "launches": launches["fused_sgd"], "max_abs_err": sgd_err,
         "shape": {k: top_sgd[k] for k in ("k", "with_losses")},
         "ms": top_sgd["ms"], "kernel_ms": top_sgd["ms"],
         "plain_ms": top_sgd["plain_ms"], "bound_ms": top_sgd["bound_ms"],
         "bound_by": top_sgd["bound_by"], "library_ms": None,
         "call_ms": top_sgd["call_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:102",
         "launches": lm_launches["flash_attention"], "max_abs_err": flash_err,
         "max_bf16_ulps": flash_ulps,
         "shape": {k: flash_row[k] for k in ("shape", "kv_heads", "dtype",
                                             "causal")},
         "ms": flash_row["ms"], "kernel_ms": flash_row["ms"],
         "plain_ms": flash_row["plain_ms"], "bound_ms": flash_row["bound_ms"],
         "bound_by": flash_row["bound_by"],
         "library_ms": flash_row["library_ms"],
         "call_ms": flash_row["call_ms"]},
        {"name": "ssd_chunk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd_chunk.py:62",
         "launches": m_launches["ssd_chunk"], "max_abs_err": ssd_err,
         "shape": {"G_H_Q_N_P": ssd_row["shape"]},
         "ms": ssd_row["ms"], "kernel_ms": ssd_row["ms"],
         "plain_ms": ssd_row["plain_ms"], "bound_ms": ssd_row["bound_ms"],
         "bound_by": ssd_row["bound_by"], "library_ms": None,
         "call_ms": ssd_row["call_ms"]},
    ]
    print(json.dumps({"aggregate_shapes": agg_rows}))
    print(json.dumps({"fused_sgd_shapes": sgd_rows}))
    print(json.dumps({"lm": {
        "config": "smollm-135m get_config() (30 layers), LMRunConfig("
                  "n_workers=8, n_rounds=30, batch=4, seq=256, adam, "
                  "lr=1e-3, eval_every=5), DySTop(V=3.0, t_thre=10, "
                  "max_neighbors=3)",
        "P": lm_agg_row["P"], "rounds": lm_hist.rounds[-1],
        "rows_trained": int(sum(lm_hist.round_active)),
        "wall_s": lm_wall, "setup_wall_s": lm_hist.setup_wall_s,
        "plan_wall_s": lm_hist.plan_wall_s,
        "pack_wall_s": lm_hist.pack_wall_s,
        "stage_wall_s": lm_hist.stage_wall_s,
        "drain_wall_s": lm_hist.drain_wall_s,
        "eval_wall_s": lm_hist.eval_wall_s, "launches": lm_launches,
        "flash_shapes": {str(s_[1:]): c for s_, c in lm_shapes.items()
                         if s_[0] == "flash_attention"},
        "aggregate_shapes": {str(s_[1:]): c for s_, c in lm_shapes.items()
                             if s_[0] == "aggregate"},
        "loss_global_first": float(lossg[0]),
        "loss_global_last": float(lossg[-1]),
        "loss_global": lossg.tolist(),
        "max_memory_allocated_bytes": lm_peak, **lm_busy,
        "card_vs_cpu_loss_gap": lm_gap, "flash": flash_row,
        "aggregate": lm_agg_row}}))
    print(json.dumps({"mamba2": {
        "config": "mamba2-2.7b get_config() at n_layers=8 (of 64), "
                  "LMRunConfig(n_workers=8, n_rounds=30, batch=4, seq=512, "
                  "adam, lr=1e-3, eval_every=5), DySTop(V=3.0, t_thre=10, "
                  "max_neighbors=3)",
        "P": p_m, "rounds": m_hist.rounds[-1],
        "rows_trained": int(sum(m_hist.round_active)),
        "wall_s": m_wall, "setup_wall_s": m_hist.setup_wall_s,
        "plan_wall_s": m_hist.plan_wall_s,
        "pack_wall_s": m_hist.pack_wall_s,
        "stage_wall_s": m_hist.stage_wall_s,
        "drain_wall_s": m_hist.drain_wall_s,
        "eval_wall_s": m_hist.eval_wall_s, "launches": m_launches,
        "ssd_shapes": {str(s_[1:]): c for s_, c in m_shapes.items()
                       if s_[0] == "ssd_chunk"},
        "aggregate_shapes": {str(s_[1:]): c for s_, c in m_shapes.items()
                             if s_[0] == "aggregate"},
        "largest_masked_exponent": m_expo,
        "loss_global": m_loss.tolist(),
        "max_memory_allocated_bytes": m_peak, **m_busy,
        "card_vs_cpu_loss_gap": m_gap, "ssd_chunk": ssd_row,
        "aggregate": m_agg_row}}))
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

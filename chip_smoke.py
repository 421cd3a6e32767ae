#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DySTop on one card: the simulation plane,
the LM fleet over two model families (dense: smollm-135m; ssm:
mamba2-2.7b), serving (grok-1-314b, the moe family, at full width), the
fleet mesh (``mesh_shards`` = 2 and 4 gloo ranks sharing the card) on the
simulation plane and the LM fleet, the Table-I arena (DySTop against four
baselines), Theorem 1's bound, and snapshots with resume on both planes.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises, and the script exits nonzero with no result):

1. print the card's name and power limit; build the five CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (N = 100 workers, P = 6,922 parameters): the Eq. 4
   ``aggregate`` over every (k, u) bucket, column-sparse (with repeated,
   zero-weighted padding columns and u = N) and row-sparse, to f32 atol and
   rtol 1e-5; at k in {8, 100, 128, 200}, at P % 4 in {0, 1, 2, 3} and at a
   base 4 bytes off 16 (the load width follows the alignment), the plain
   version's values and the same bits as the 4-wide loads give on the same
   columns, and an out-of-range column id turning every output NaN; the Eq. 5
   ``fused_sgd`` at k in {8, 16, 100}, at batch 30, at widths 20-48-36-7
   and at 50 steps, with losses on and off, to atol 1e-4 (the sums run in
   another order than the plain version's batched products), inactive rows
   bit-identical, the same bits on a second launch and for a row alone as
   among k;
2b. ``aggregate`` past 2^31 columns: k = 2 rows of an (N = 2, P = 2^31 +
   4,096) buffer (X and Y 17.2 GB each), the column windows at the start,
   across 2^31 and at the end held against ``aggregate_plain`` on the same
   windows (f32 atol and rtol 1e-5), timed beside its bound; freed after;
3. zero the launch counters, run ``run_simulation(DySTop(V=10, t_thre=20),
   SimConfig())`` at the defaults on the card, read the counters (both
   kernels must have launched) and check that accuracy rose;
4. time each kernel (CUDA events, median of 60 launches queued behind a
   device-side sleep, so the time is the card's and not the host's) beside
   its plain version, one PyTorch library call where one computes the same
   function, and its bound — the larger of the bytes it must move over
   3.35 TB/s and its flops over 67 TFLOP/s f32 — at every shape the main
   path launched (``aggregate`` also on a (1, 1) x (1, 128) call beside one
   PyTorch elementwise launch: the floor of this timing);
5. run a 60-round copy of the config on the card and on the CPU: the
   control plane must match exactly and the accuracy curve within 1e-3
   (both runs draw identical batches);
6. run the main path once more under ``torch.profiler`` and report the
   card's kernel time and its share of phase 3's wall time;
7. hold the flash-attention kernel against its plain version on the card,
   in bf16 and f32: the LM path's shape (4, 9, 256, 64) causal with 3 kv
   heads, a ragged S = 200, window 64, softcap 50, (1, 8, 1024, 128), and
   window 0 (every row fully masked, the first rows included) beside a
   non-causal window of -32 (the last 33 rows fully masked), and (8, 8,
   950, 256) with window 300 and softcap 30 (bf16: two warpgroups, the
   second past S in the last tile); in bf16 only (the f32 kernel must
   refuse them), the bf16 kernel's lifted limits: D = 112 (kimi-k2), D =
   32 and B = 70,000 — f32 to 1e-5 absolute, bf16
   to 2 bf16 ulps of the larger magnitude after 1e-6 of f32 sum-order
   noise; a bf16 input whose stride or base is not 16-byte aligned must
   raise without a launch;
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
   TFLOP/s bf16 or 67 TFLOP/s f32), and the same at grok-1-314b's
   attention widths (1, 48, 4096, 128) with 8 kv heads and no softcap (so
   the library call computes the same function) and gemma2-2b's (2, 8,
   4096, 256) with 4 kv heads, softcap 50 and window 4096 (the library
   call: compiled ``flex_attention`` with the softcap as its score_mod),
   each held to 2 bf16 ulps first; the library call's own distance from
   the plain version is reported; aggregate over the fleet's real (8, P)
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
   a ragged Q = 200, a large ``dt`` whose masked exponents pass 88, and a
   ``cum_la`` that rises (a random walk; a spike that would overflow a
   decay split at a tile's first row), held on the rows the plain version
   gives finite;
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
   ``loss_global`` within 2e-2;
15. hold the ``moe_router`` kernel against its plain version on the card:
   (T, E, k) = (8, 8, 2) (the serving path's decode shape), (4096, 8, 2),
   (4096, 384, 8) (kimi-k2's experts) and a ragged T = 300, each with rows
   of all-equal logits, of duplicated maxima and of +-1e4 — ids identical,
   gates within 1e-6 and finite;
16. zero the launch counters and serve grok-1-314b at full width and 4 of
   its 64 layers: ``replace(grok_1_314b.get_config(), n_layers=4)`` drawn
   on the card from a CUDA generator, ``ServeEngine(batch_slots=8,
   max_len=512, seed=0, device="cuda")`` under ``traffic.drive`` on the
   wall clock over ``ARRIVAL_PRESETS["steady"]`` (Poisson 6 req/s, 24
   requests, prompts 4-24, generations 8-32, greedy, seed 11).  Every
   request must finish with its ``max_new_tokens`` tokens, every tick's
   logits be finite, ``moe_router`` launch once per MoE layer per tick and
   flash_attention, ssd_chunk, aggregate and fused_sgd not at all.  Reports
   tokens/s, TTFT and per-token latency p50/p99, occupancy, ms per tick,
   peak memory, init wall, and the card's busy share over a profiled second
   drive of the same requests;
17. time ``moe_router`` at (8, 8, 2) and (4096, 384, 8) beside its plain
   version and its bound (T E 4 + T k 8 bytes over 3.35 TB/s; no single
   PyTorch call computes it);
18. serve the same 8 greedy requests from the same parameters through the
   engine on the card and on the CPU, on the smoke geometries of grok,
   smollm-135m and mamba2-2.7b: a stream may leave the CPU's only at a step
   where the CPU's top-2 logit gap is under ``SERVE_CARD_CPU_TOL`` (such
   steps are counted), and the card's logits, teacher-forced on the CPU's
   streams, must be within that tolerance of the CPU's.

Phases 19-21 run the fleet mesh: for S in (2, 4) the script spawns S ranks
(``launch.mesh.spawn``; gloo, every rank on ``cuda:0``) that run phases 19
and 20, and at S = 2 phase 21; each check raises inside its rank, which
fails the whole call.

19. hold each mesh twin against its plain version on the whole buffer:
   ``aggregate_rows_sharded`` and ``aggregate_rows_cols_sharded`` over the
   sim path's buckets (N = 100, P = 6,922, padding columns included) and,
   at S = 2, ``aggregate_rows_sharded`` on the LM fleet's (8, P =
   134,515,008) buffer at k = 2, to f32 atol and rtol 1e-5;
   ``fused_sgd_sharded`` bit-identical to the unsharded kernel on the same
   rows and within 1e-4 of the plain version.  Time, on each rank, the
   per-shard ``aggregate`` launch (ranks in turn), the all-reduce and the
   whole twin (host wall, ranks together), beside the unsharded kernel, the
   plain version, ``matmul`` and the per-shard bound;
20. zero the counters on each rank, run ``run_simulation(DySTop(V=10,
   t_thre=20), SimConfig(mesh_shards=S))`` at the defaults, read them: every
   rank must have launched ``aggregate`` and ``fused_sgd``, the control
   plane must equal phase 3's exactly, ``acc_global`` be within 2e-2 of it
   and every rank's final block finite;
21. (S = 2) the LM fleet of phase 8 at 10 rounds with ``mesh_shards=2``,
   against an unsharded 10-round run of the same config: control plane
   identical, ``loss_global`` within rtol 1e-3, ``flash_attention`` and
   ``aggregate`` launched on both ranks, the assembled fleet finite;
   reports the wall, the all-reduce time per round and each rank's peak
   memory.

Phases 22-25 run the Table-I arena, the convergence bound and snapshots:

22. the arena's headline cell (``benchmarks/arena.py::main``'s phi 0.4
   clean cell with ``benchmarks/common.py::run_mech``'s settings, copied
   into ``ARENA_CFG``: 24 workers, a 6,000-round cap, 4,000 simulated s,
   target 0.55, seed 0): each of DySTop, MATCHA, GossipFL, AsyDFL and
   SA-ADFL runs ``run_simulation`` on the card with the counters zeroed
   (``aggregate`` and ``fused_sgd`` must launch), on the CPU (control
   plane identical, ``acc_global`` within 1e-3 at every eval) and once more
   on the card under the profiler (the busy share); reports t@0.55, comm
   GB@0.55, the final accuracy, wall and busy share per mechanism, and
   DySTop's savings against the best ADFL baseline beside the JAX
   package's CPU figures; then holds each kernel at the cell's new shapes
   against its plain version and times it beside the library call and its
   bound;
23. DySTop and AsyDFL on the same cell for 100 rounds with a bound log, on
   the card and on the CPU: Theorem 1's bound over the two logs must be
   equal to the last bit;
24. a child process (``chip_smoke.py --sim-child DIR``) runs
   ``SimConfig()`` with the churn20 scenario and a snapshot every 50
   rounds on the card and gets SIGKILL once its second snapshot exists;
   the run resumed on the card from the oldest snapshot left must equal an
   uninterrupted checkpointing run on the card (control plane exactly,
   curves within rtol 1e-6 / atol 1e-7; whether they are bit-equal is
   reported);
25. smollm-135m at full width with 2 workers (cut from phase 8's 8: a
   snapshot holds 12 bytes per parameter per worker, 3.2 GB here) for 6
   rounds with a snapshot every 3 (the free disk is checked first); the
   run resumed from round 3 must equal the uninterrupted one on the
   control plane and within rtol 1e-3 on ``loss_global``; 8 greedy requests
   served through ``serving.bridge`` from the round-6 snapshot, for worker 0
   and for the Eq. 11 global model, must all complete, the served
   parameters being the snapshot's row bit for bit; the snapshots are
   deleted afterwards.

Prints ``{"aggregate_shapes"}``, ``{"fused_sgd_shapes"}``, ``{"lm": ...}``,
``{"mamba2": ...}``, ``{"serving": ...}``, ``{"mesh": ...}``, ``{"arena":
...}``, ``{"convergence": ...}``, ``{"sigkill_resume": ...}``,
``{"lm_snapshot": ...}``, ``{"kernels": [...]}`` (the three mesh twins as
row 3) and ``{"sim": {...}}`` lines, the card's name and power limit and,
as the last line, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
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
MESH_SHARDS = (2, 4)               # gloo ranks sharing the one card
MESH_ACC_TOL = 2e-2                # acc_global, sim mesh vs unsharded
MESH_LOSS_RTOL = 1e-3              # loss_global, LM mesh vs unsharded
LM_CARD_CPU_TOL = 2e-2             # loss_global, card vs CPU, bf16 smoke run
SERVE_CARD_CPU_TOL = 0.25          # logits, card vs CPU, bf16 smoke serving


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


def mlp_stacked(d: int, h: int, g: int, c: int):
    """A one-row stacked MLP of widths d-h-g-c (only its shapes are used)."""
    import torch
    return {"b1": torch.zeros((1, h)), "b2": torch.zeros((1, g)),
            "b3": torch.zeros((1, c)), "w1": torch.zeros((1, d, h)),
            "w2": torch.zeros((1, h, g)), "w3": torch.zeros((1, g, c))}


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


def flash_long_row(gen, dev, label, b, h, hk, s, d, softcap, window):
    """Hold the bf16 flash kernel against its plain version at (b, h, s, d)
    causal on the model's (B, S, H, D) views and time it beside the plain
    version, its bound and one library call that computes the same function:
    ``scaled_dot_product_attention`` with the kv heads repeated where there
    is no softcap and no window, else ``flex_attention`` (compiled) with the
    softcap as its score_mod, causal and window as its block mask, and the
    kv heads grouped in place.  The library call's own distance from the
    plain version is reported."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    bf = torch.bfloat16
    q = torch.randn((b, s, h, d), generator=gen).to(dev, bf).transpose(1, 2)
    k = torch.randn((b, s, hk, d), generator=gen).to(dev, bf).transpose(1, 2)
    v = torch.randn((b, s, hk, d), generator=gen).to(dev, bf).transpose(1, 2)
    got = FA.flash_attention(q, k, v, True, window, softcap)
    want = FA.flash_attention_plain(q, k, v, True, window, softcap)
    torch.cuda.synchronize()
    ulps = bf16_ulps(got.float(), want.float())
    check(bool(torch.isfinite(got).all()) and ulps <= 2.0,
          f"flash {label}: {ulps} bf16 ulps")
    b_ms, b_by = flash_cost(q, k, True, window)
    row = {"label": label, "shape": [b, h, s, d], "kv_heads": hk,
           "dtype": str(bf), "causal": True, "window": window,
           "softcap": softcap, "max_bf16_ulps": ulps,
           "ms": device_ms(lambda: FA.flash_attention(q, k, v, True, window,
                                                      softcap), 20),
           "plain_ms": device_ms(lambda: FA.flash_attention_plain(
               q, k, v, True, window, softcap), 5),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if softcap is None and window is None:
        k_rep = k.repeat_interleave(h // hk, dim=1)
        v_rep = v.repeat_interleave(h // hk, dim=1)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=True)
        row["library_ms"] = device_ms(sdpa, 20)
        row["library_bf16_ulps"] = bf16_ulps(sdpa().float(), want.float())
        row["library"] = "scaled_dot_product_attention"
        return row
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def keep(b_, h_, q_, k_):
        inside = k_ <= q_
        return inside if window is None else inside & (q_ - k_ < window)

    def cap(score, b_, h_, q_, k_):
        return score if softcap is None else torch.tanh(
            score / softcap) * softcap

    block = create_block_mask(keep, None, None, s, s, device=dev)
    flex_c = torch.compile(flex_attention, dynamic=False)
    flex = lambda: flex_c(q, k, v, score_mod=cap, block_mask=block,
                          enable_gqa=True)
    row["library_ms"] = device_ms(flex, 20)
    row["library_bf16_ulps"] = bf16_ulps(flex().float(), want.float())
    row["library"] = "flex_attention"
    return row


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
        "label": label, "k": k, "u": u, "col_sparse": col, "P": p,
        "rounds": count, "launches": launches, "max_abs_err": err,
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


def router_logits(gen, t: int, e: int, dev):
    """Random (T, E) logits with rows of all-equal logits, of duplicated
    maxima and of +-1e4 at the top."""
    import torch
    x = torch.randn((t, e), generator=gen) * 3
    x[0] = 1.0
    x[1] = -5.0
    x[1, [1, e - 1]] = 2.0
    x[2, : e // 2] = 1e4
    x[2, e // 2:] = -1e4
    x[3, -1] = float(x[3].max()) + 1.0
    x[3, :2] = x[3, -1]
    return x.to(dev)


def router_tie_logits(t: int, e: int, dev):
    """(T, E) logits in which every row ties: all equal, a maximum repeated
    at two indices, half at +1e4 and half at -1e4, and distinct logits that
    all underflow to probability 0 beside one leader (rising with the index,
    so a pick on logits would take the highest index first), in turn."""
    import torch
    rows = torch.empty((4, e))
    rows[0] = 1.0
    rows[1] = -5.0
    rows[1, [1, e - 1]] = 2.0
    rows[2, : e // 2] = 1e4
    rows[2, e // 2:] = -1e4
    rows[3] = -200.0 - 0.5 * (e - torch.arange(e, dtype=torch.float32))
    rows[3, e // 3] = 50.0
    return rows.repeat((t + 3) // 4, 1)[:t].contiguous().to(dev)


def router_cost(t: int, e: int, k: int):
    """Bytes: the f32 logits read once, gates (f32) and ids (i32) written
    once; its compares are far below any unit's rate."""
    return bound(4.0 * t * e + 8.0 * t * k, 0.0)


def serve_requests(cfg, n: int, seed: int):
    from repro_torch.serving import TrafficConfig, generate_requests
    return generate_requests(TrafficConfig(n_requests=n, prompt_len=(4, 12),
                                           gen_len=(8, 16), seed=seed),
                             cfg.vocab_size)


def teacher_forced(cfg, params, prompt, out, dev):
    """Logits (len(out), V) for each generated token of a request: the
    engine feeds the prompt, its last token again, then the stream."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as T
    seq = np.concatenate([prompt, prompt[-1:], out[:-1]]).astype(np.int64)
    cache = R.init_decode_cache(cfg, ShapeSpec("tf", len(seq), 1, "decode"),
                                dev)
    with torch.no_grad():
        logits, _ = T.prefill_cache(cfg, params, cache,
                                    torch.from_numpy(seq)[None].to(dev))
    return logits[0, len(prompt):, :cfg.vocab_size].float().cpu()


def serve_card_vs_cpu(cfg, label: str) -> dict:
    """The same params and 8 greedy requests through the engine on the card
    and on the CPU.  A stream may leave the CPU's only where the CPU's top-2
    gap is under ``SERVE_CARD_CPU_TOL``; the card's logits teacher-forced on
    the CPU's streams must be within it.  Returns the counts and gaps."""
    import numpy as np
    import torch
    from repro_torch.models import registry as R
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import tree_map
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    card_params = tree_map(lambda t: t.to("cuda"), params)
    reqs = serve_requests(cfg, 8, 21)
    outs = {}
    for dev, p in (("cuda", card_params), ("cpu", params)):
        eng = ServeEngine(cfg, p, batch_slots=4, max_len=64, device=dev)
        for r in reqs:
            eng.submit(r.prompt, r.gen)
        outs[dev] = eng.run()
    near_ties, max_gap, tf_err = 0, 0.0, 0.0
    for rid, r in enumerate(reqs):
        want = np.asarray(outs["cpu"][rid])
        got = np.asarray(outs["cuda"][rid])
        check(len(got) == len(want) == r.gen.max_new_tokens,
              f"{label}: request {rid} has {len(got)} tokens on the card, "
              f"{len(want)} on the CPU")
        cpu_l = teacher_forced(cfg, params, r.prompt, want, "cpu")
        card_l = teacher_forced(cfg, card_params, r.prompt, want, "cuda")
        tf_err = max(tf_err, float((card_l - cpu_l).abs().max()))
        diff = np.nonzero(got != want)[0]
        if len(diff):
            top2 = torch.sort(cpu_l[diff[0]]).values[-2:]
            gap = float(top2[1] - top2[0])
            check(gap < SERVE_CARD_CPU_TOL,
                  f"{label}: request {rid} leaves the CPU's stream at step "
                  f"{diff[0]}, where the CPU's top-2 gap is {gap}")
            near_ties += 1
            max_gap = max(max_gap, gap)
    check(tf_err <= SERVE_CARD_CPU_TOL,
          f"{label}: teacher-forced logits, card vs CPU, differ by {tf_err}")
    print(f"serving {label} card vs CPU: {len(reqs)} requests, "
          f"{near_ties} streams leave the CPU's at a near tie, "
          f"teacher-forced max |logit gap| {tf_err:.3e}", flush=True)
    return {"requests": len(reqs), "near_tie_streams": near_ties,
            "largest_tie_gap": max_gap, "teacher_forced_max_abs_err": tf_err}


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_ms(fn, dev, reps: int) -> float:
    """Median host wall of ``fn`` over ``reps`` calls, each synchronised
    before and after (a collective's time is the host's: gloo runs it)."""
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rank_serial(fn):
    """Run ``fn`` on each rank in turn (barriers between), so that ranks
    sharing one card time their kernels alone; returns this rank's result."""
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        dist.barrier()
        if dist.get_rank() == r:
            out = fn()
    dist.barrier()
    return out


def zero_counters() -> None:
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_sgd as FSGD
    AGG.launches = AGG.launches_rows_sharded = AGG.launches_cols_sharded = 0
    FSGD.launches = FSGD.launches_sharded = FA.launches = 0


def read_counters() -> dict:
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_sgd as FSGD
    return {"aggregate": AGG.launches, "fused_sgd": FSGD.launches,
            "flash_attention": FA.launches,
            "aggregate_rows_sharded": AGG.launches_rows_sharded,
            "aggregate_rows_cols_sharded": AGG.launches_cols_sharded,
            "fused_sgd_sharded": FSGD.launches_sharded}


def mesh_twin_rows(shd, W, X, block, seg, cid, reps: int, label: str) -> dict:
    """Phase 19 for one twin at one shape: hold this rank's rows against the
    plain version on the whole buffer (f32 atol and rtol 1e-5), then time
    the per-shard launch (ranks in turn), the all-reduce and the whole twin
    (ranks together), beside the unsharded kernel, its plain version and
    ``matmul`` (rank 0)."""
    import torch
    from repro_torch.kernels import aggregate as AGG
    dev = shd.device
    lo, hi = seg
    k, p = W.shape[0], X.shape[1]
    if cid is None:
        twin = lambda: AGG.aggregate_rows_sharded(W, block, shd, seg)
        Wb = W[:, shd.home[0]:shd.home[1]].contiguous()
        shard_in = (Wb, block)
        part = torch.zeros((k, p), dtype=torch.float32, device=dev)
        b_ms, b_by = agg_cost(k, Wb.cpu(), None, p, shd.block)
        W_full = W[:, :shd.n_rows].contiguous()
    else:
        twin = lambda: AGG.aggregate_rows_cols_sharded(W, cid, block, shd,
                                                       seg)
        shard_in = None if hi == lo else (
            W[lo:hi], torch.randn((cid.shape[0], p), device=dev))
        part = torch.zeros((cid.shape[0], p), dtype=torch.float32,
                           device=dev)
        b_ms, b_by = ((None, None) if hi == lo else
                      agg_cost(hi - lo, W[lo:hi].cpu(), None, p,
                               cid.shape[0]))
        W_full = W
    got = twin()
    want = AGG.aggregate_plain(W_full[lo:hi], X, cid)
    sync(dev)
    err = float((got - want).abs().max()) if hi > lo else 0.0
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5,
                               msg=lambda m: f"{label}: {m}")
    del got, want
    ms = rank_serial(lambda: None if shard_in is None else device_ms(
        lambda: AGG.aggregate(*shard_in), reps=reps))
    row = {"shape": label, "rank": shd.rank, "seg": [lo, hi],
           "max_abs_err": err, "shard_ms": ms,
           "allreduce_ms": wall_ms(lambda: shd.psum(part), dev, reps),
           "twin_ms": wall_ms(twin, dev, reps),
           "shard_bound_ms": b_ms, "shard_bound_by": b_by}

    def unsharded():
        lib_cid = None if cid is None else cid.long()
        return {"unsharded_ms": device_ms(
                    lambda: AGG.aggregate(W_full, X, cid), reps=reps),
                "plain_ms": device_ms(
                    lambda: AGG.aggregate_plain(W_full, X, cid), reps=reps),
                "library_ms": device_ms(
                    (lambda: torch.matmul(W_full, X)) if cid is None else
                    (lambda: torch.matmul(W_full, X.index_select(0, lib_cid))),
                    reps=reps)}

    row.update(rank_serial(lambda: unsharded() if shd.rank == 0 else {}))
    return row


def mesh_twins(plan: dict) -> dict:
    """Phase 19 on this rank: every twin against its plain version at the
    sim path's buckets (and at S = 2 on the LM fleet's buffer), timed at
    the main path's commonest shapes."""
    import numpy as np
    import torch
    from repro_torch.dfl import flat_state as FS
    from repro_torch.dfl import worker as WK
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import fused_sgd as FSGD
    from repro_torch.sharding.rules import FleetSharding
    import torch.distributed as dist
    n, p, reps = plan["n"], plan["P"], plan["reps"]
    shd = FleetSharding.create(dist.get_world_size(), n, plan["device"])
    dev = shd.device
    gen = torch.Generator().manual_seed(4321)   # the same draws on each rank
    X = torch.randn((n, p), generator=gen).to(dev)
    block = shd.put_rows_padded(X)
    buckets = plan["buckets"]

    def ids(k):
        return np.sort(torch.randperm(n, generator=gen)[:k].numpy())

    errs = {"rows": 0.0, "cols": 0.0, "sgd_vs_kernel": 0.0, "sgd_vs_plain": 0.0}
    for k in buckets:
        rid = ids(k)
        seg = shd.for_rows(rid)
        W, _ = agg_case(gen, k, n, n, False, dev)
        W = torch.from_numpy(WK.pad_w_cols(W.cpu().numpy(), shd.n_pad)).to(dev)
        got = AGG.aggregate_rows_sharded(W, block, shd, seg)
        want = AGG.aggregate_plain(W[seg[0]:seg[1], :n], X)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        errs["rows"] = max(errs["rows"], float((got - want).abs().max())
                           if len(got) else 0.0)
        for u in buckets:
            W_sub, cid = agg_case(gen, k, u, n, True, dev)
            got = AGG.aggregate_rows_cols_sharded(W_sub, cid, block, shd, seg)
            want = AGG.aggregate_plain(W_sub[seg[0]:seg[1]], X, cid)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            errs["cols"] = max(errs["cols"], float((got - want).abs().max())
                               if len(got) else 0.0)
    spec = FS.spec_of(WK.init_stacked(torch.Generator(), 1, plan["dim"],
                                      plan["hidden"], 10))
    steps, batch, lr = plan["steps"], plan["batch"], plan["lr"]
    for k in plan["sgd_ks"]:
        for with_losses in (True, False):
            buf, xb, yb, active = sgd_case(gen, k, steps, batch, plan["dim"],
                                           10, dev, spec.n_params)
            a, b = shd.for_rows(ids(k))
            got, g_loss = FSGD.fused_sgd_sharded(
                buf[a:b], xb[a:b], yb[a:b], active[a:b], spec, lr,
                with_losses)
            ker, k_loss = FSGD.fused_sgd(buf, xb, yb, active, spec, lr,
                                         with_losses)
            pl, p_loss = FSGD.local_sgd_flat_fused(buf, xb, yb, active, spec,
                                                   lr, with_losses)
            sync(dev)
            check(torch.equal(got, ker[a:b]) and torch.equal(g_loss,
                                                             k_loss[a:b]),
                  f"fused_sgd_sharded (k={k}) differs from the unsharded "
                  f"kernel on rank {shd.rank}")
            torch.testing.assert_close(got, pl[a:b], atol=1e-4, rtol=0)
            torch.testing.assert_close(g_loss, p_loss[a:b], atol=1e-4, rtol=0)
            errs["sgd_vs_plain"] = max(
                errs["sgd_vs_plain"], float((got - pl[a:b]).abs().max())
                if b > a else 0.0)
    out = {"rank": shd.rank, "backend": shd.mesh.backend,
           "device": str(dev), "max_abs_err": errs, "times": []}

    # times at the sim path's commonest shapes
    for k, u, col in plan["agg_top"]:
        rid = ids(k)
        seg = shd.for_rows(rid)
        if col:
            W, cid = agg_case(gen, k, u, n, True, dev)
        else:
            W, cid = agg_case(gen, k, n, n, False, dev)
            W = torch.from_numpy(WK.pad_w_cols(W.cpu().numpy(),
                                               shd.n_pad)).to(dev)
        out["times"].append(mesh_twin_rows(
            shd, W, X, block, seg, cid, reps,
            f"sim k={k} u={u} {'cols' if col else 'rows'}"))
    k = plan["sgd_top"]
    buf, xb, yb, active = sgd_case(gen, k, steps, batch, plan["dim"], 10,
                                   dev, spec.n_params)
    a, b = shd.for_rows(ids(k))
    args = (buf[a:b], xb[a:b], yb[a:b], active[a:b], spec, lr, False)
    out["sgd_time"] = {
        "k": k, "seg": [a, b], "rank": shd.rank,
        "shard_ms": rank_serial(lambda: device_ms(
            lambda: FSGD.fused_sgd_sharded(*args), reps=reps)
            if b > a else None),
        "shard_bound": sgd_cost(spec, active[a:b], b - a, steps, batch,
                                False) if b > a else None,
        **rank_serial(lambda: {
            "unsharded_ms": device_ms(lambda: FSGD.fused_sgd(
                buf, xb, yb, active, spec, lr, False), reps=reps),
            "plain_ms": device_ms(lambda: FSGD.local_sgd_flat_fused(
                buf, xb, yb, active, spec, lr, False), reps=reps)}
            if shd.rank == 0 else {})}

    lmt = plan.get("lm_twin")
    if lmt is not None:        # the LM fleet's (8, P) buffer, drawn on dev
        del X, block
        lshd = FleetSharding.create(shd.n_shards, lmt["n"], plan["device"])
        dgen = (torch.Generator(device=dev) if dev.type == "cuda"
                else torch.Generator()).manual_seed(99)
        Xl = torch.randn((lmt["n"], lmt["P"]), generator=dgen, device=dev)
        lblock = lshd.put_rows_padded(Xl)
        rid = np.asarray(lmt["row_ids"])
        Wl = torch.rand((len(rid), lmt["n"]), generator=gen)
        Wl = (Wl / Wl.sum(1, keepdim=True)).to(dev)
        out["lm_time"] = mesh_twin_rows(
            lshd, Wl, Xl, lblock, lshd.for_rows(rid), None, lmt["reps"],
            f"lm k={len(rid)} P={lmt['P']} rows")
        del Xl, lblock
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def mesh_sim(plan: dict) -> dict:
    """Phase 20 on this rank: its share of ``run_simulation`` with
    ``mesh_shards`` = the group's size, counters zeroed just before and
    read just after; the final block must be finite."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import worker as WK
    from repro_torch.dfl.simulator import run_simulation
    cfg = dataclasses.replace(plan["sim_cfg"],
                              mesh_shards=dist.get_world_size())
    dev = torch.device(plan["device"])
    last = []
    orig = WK.mega_round_step

    def rec_mega(buf, *a, **kw):
        last[:] = [buf]
        return orig(buf, *a, **kw)

    WK.mega_round_step = rec_mega
    zero_counters()
    sync(dev)
    t0 = time.perf_counter()
    try:
        hist = run_simulation(DySTop(V=10.0, t_thre=20), cfg,
                              device=plan["device"])
    finally:
        WK.mega_round_step = orig
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counters()
    return {"rank": dist.get_rank(), "wall_s": wall, "launches": launches,
            "block_finite": bool(torch.isfinite(last[0]).all()),
            "block_rows": last[0].shape[0],
            "history": {**hist.to_dict(), "mesh_backend": hist.mesh_backend}}


def mesh_lm(plan: dict) -> dict:
    """Phase 21 on this rank: its share of the LM fleet run with
    ``mesh_shards=2``; counters zeroed just before and read just after,
    each all-reduce timed, rank 0's assembled fleet checked finite."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import lm_worker as LW
    from repro_torch.sharding.rules import FleetSharding
    cfg, run = plan["lm"]
    run = dataclasses.replace(run, mesh_shards=dist.get_world_size())
    dev = torch.device(plan["device"])
    times, sizes = [], []
    orig = FleetSharding.psum

    def timed_psum(self, x):
        sync(self.device)
        t0 = time.perf_counter()
        out = orig(self, x)
        sync(self.device)
        times.append(time.perf_counter() - t0)
        sizes.append(x.numel() * x.element_size())
        return out

    FleetSharding.psum = timed_psum
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_counters()
    sync(dev)
    t0 = time.perf_counter()
    try:
        fleet, hist = LW.run_lm_federation(
            DySTop(V=3.0, t_thre=10, max_neighbors=3), cfg, run,
            device=plan["device"])
    finally:
        FleetSharding.psum = orig
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counters()
    out = {"rank": dist.get_rank(), "wall_s": wall, "launches": launches,
           "allreduce_s": sum(times), "allreduce_calls": len(times),
           "allreduce_bytes": sum(sizes),
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None),
           "history": {**hist.to_dict(), "mesh_backend": hist.mesh_backend}}
    if fleet is not None:
        out["fleet_shape"] = [list(fleet.pbuf.shape), list(fleet.obuf.shape)]
        out["fleet_finite"] = all_finite(fleet.pbuf) and all_finite(
            fleet.obuf)
    del fleet
    return out


def mesh_rank(plan: dict) -> list:
    """One rank of phases 19-21; every rank's results, gathered."""
    import torch.distributed as dist
    out = {"twins": mesh_twins(plan), "sim": mesh_sim(plan)}
    if plan.get("lm") is not None:
        out["lm"] = mesh_lm(plan)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


def mesh_checks(n_sh: int, ranks: list, spawn_wall: float, hist, lm10_hist,
                lm10_wall: float, lm_workers: int, lm_p: int) -> dict:
    """Phases 19-21's checks on the ranks' results (phase 19's ran inside
    the ranks): the sim mesh against phase 3's run ``hist``, the LM mesh
    against the unsharded 10-round run; returns the ``{"mesh"}`` entry."""
    import numpy as np
    sim_ctrl = ("rounds", "sim_time", "comm_gb", "round_active",
                "round_durations", "staleness_avg", "staleness_max")
    # 19: every twin held against its plain version inside each rank
    tw = [r["twins"] for r in ranks]
    check(all(t["backend"] == "gloo" for t in tw),
          f"mesh S={n_sh}: backends {[t['backend'] for t in tw]}")
    print(f"phase 19, S={n_sh}: twins match their plain versions on "
          f"every rank, max |err| "
          f"{[t['max_abs_err'] for t in tw]}", flush=True)
    # 20: the sim mesh against phase 3's unsharded run
    sims = [r["sim"] for r in ranks]
    for r in sims:
        check(r["launches"]["aggregate"] > 0
              and r["launches"]["fused_sgd"] > 0,
              f"sim mesh S={n_sh} rank {r['rank']}: a kernel never "
              f"launched: {r['launches']}")
        check(r["block_finite"], f"sim mesh S={n_sh} rank {r['rank']}: "
              f"the final block is not finite")
    mh = sims[0]["history"]
    check(mh["mesh_backend"] == "gloo",
          f"sim mesh S={n_sh}: backend {mh['mesh_backend']}")
    for f in sim_ctrl:
        check(mh[f] == getattr(hist, f),
              f"sim mesh S={n_sh}: {f} differs from phase 3's run")
    acc_gap_m = float(np.max(np.abs(np.asarray(mh["acc_global"])
                                    - np.asarray(hist.acc_global))))
    check(acc_gap_m <= MESH_ACC_TOL,
          f"sim mesh S={n_sh}: acc_global differs by {acc_gap_m}")
    print(f"phase 20, S={n_sh}: control plane identical to phase 3, "
          f"max |acc gap| {acc_gap_m:.2e}, launches "
          f"{[r['launches'] for r in sims]}, rank walls "
          f"{[round(r['wall_s'], 2) for r in sims]} s", flush=True)
    run_out = {"spawn_wall_s": spawn_wall, "twins": tw,
               "sim": {"acc_gap": acc_gap_m, "ranks": [
                   {k_: r[k_] for k_ in ("rank", "wall_s", "launches",
                                         "block_rows")} for r in sims],
                   "history": {k_: mh[k_] for k_ in (
                       "wall_s", "setup_wall_s", "plan_wall_s",
                       "pack_wall_s", "stage_wall_s", "drain_wall_s",
                       "eval_wall_s", "mesh_backend")},
                   "acc_final": mh["acc_global"][-1]}}
    if n_sh == 2:
        # 21: the LM mesh against the unsharded 10-round run
        lms = [r["lm"] for r in ranks]
        for r in lms:
            check(r["launches"]["flash_attention"] > 0
                  and r["launches"]["aggregate"] > 0,
                  f"LM mesh rank {r['rank']}: a kernel never launched: "
                  f"{r['launches']}")
        lh = lms[0]["history"]
        for f in sim_ctrl:
            check(lh[f] == getattr(lm10_hist, f),
                  f"LM mesh: {f} differs from the unsharded run")
        lg, lg1 = (np.asarray(lh["loss_global"]),
                   np.asarray(lm10_hist.loss_global))
        check(lg.shape == lg1.shape and np.isfinite(lg).all()
              and np.allclose(lg, lg1, rtol=MESH_LOSS_RTOL, atol=0),
              f"LM mesh loss_global {lg.tolist()} vs {lg1.tolist()}")
        check(lms[0]["fleet_finite"], "LM mesh: the fleet is not finite")
        check(lms[0]["fleet_shape"][0] == [lm_workers,
                                           lm_p],
              f"LM mesh fleet shape {lms[0]['fleet_shape']}")
        rounds_m = lh["rounds"][-1]
        print(f"phase 21: LM mesh {rounds_m} rounds, walls "
              f"{[round(r['wall_s'], 2) for r in lms]} s (unsharded "
              f"{lm10_wall:.2f} s), all-reduce "
              f"{lms[0]['allreduce_s'] / rounds_m:.3f} s per round, "
              f"peaks {[r['peak_bytes'] for r in lms]} B, loss "
              f"{lg.tolist()} vs {lg1.tolist()}", flush=True)
        run_out["lm"] = {
            "loss_global": lg.tolist(),
            "unsharded_loss_global": lg1.tolist(),
            "max_loss_rel_gap": float(np.max(np.abs(lg - lg1)
                                             / np.abs(lg1))),
            "unsharded_wall_s": lm10_wall,
            "unsharded_history": {k_: getattr(lm10_hist, k_) for k_ in (
                "wall_s", "setup_wall_s", "drain_wall_s",
                "eval_wall_s")},
            "ranks": [{k_: r[k_] for k_ in (
                "rank", "wall_s", "launches", "allreduce_s",
                "allreduce_calls", "allreduce_bytes", "peak_bytes")}
                for r in lms],
            "allreduce_s_per_round": lms[0]["allreduce_s"] / rounds_m,
            "history": {k_: lh[k_] for k_ in (
                "wall_s", "setup_wall_s", "plan_wall_s", "pack_wall_s",
                "stage_wall_s", "drain_wall_s", "eval_wall_s")}}
    return run_out


def mesh_kernel_rows(mesh_runs: dict, sgd_floor: dict) -> list:
    """Row 3 of the kernel table (the three twins) for the ``{"kernels"}``
    line, from phase 19's timings and phases 20-21's launch counts (and
    phase 4's floor of the fused_sgd timing)."""
    def twin_launches(name):
        return sum(r["launches"][name] for run_out in mesh_runs.values()
                   for part in ("sim", "lm") if part in run_out
                   for r in run_out[part]["ranks"])

    def twin_entry(name, replaces, src, rows, err, extra):
        """Row 3 of the kernel table from phase 19's S=2 timings: the
        per-shard launch of the first rank with rows (``ms``, beside that
        launch's bound), the whole-buffer plain version and library call
        (rank 0), every rank's all-reduce and twin times."""
        shard = next(r for r in rows if r.get("shard_ms") is not None)
        bnd = shard.get("shard_bound")
        b_ms, b_by = bnd if bnd is not None else (shard["shard_bound_ms"],
                                                  shard["shard_bound_by"])
        return {"name": name, "route": "cuda", "source": src,
                "wrapper": extra.pop("wrapper"), "replaces": replaces,
                "launches": twin_launches(name), "max_abs_err": err,
                "ms": shard["shard_ms"], "plain_ms": rows[0]["plain_ms"],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": rows[0].get("library_ms"),
                "unsharded_ms": rows[0]["unsharded_ms"],
                "timed_rank": shard["rank"], "per_rank": rows, **extra}

    tw2 = mesh_runs[2]["twins"]
    errs_all = [t["max_abs_err"] for run_out in mesh_runs.values()
                for t in run_out["twins"]]
    lm_twin_rows = [t["lm_time"] for t in tw2]
    return [
        twin_entry("aggregate_rows_sharded",
                   "src/repro/kernels/aggregate.py:140",
                   "src/repro_torch/kernels/csrc/aggregate.cu",
                   [t["times"][1] for t in tw2],
                   max([e["rows"] for e in errs_all]
                       + [r["max_abs_err"] for r in lm_twin_rows]),
                   {"wrapper": "src/repro_torch/kernels/aggregate.py",
                    "shards": 2, "shape": tw2[0]["times"][1]["shape"],
                    "lm": lm_twin_rows,
                    "s4": [t["times"][1] for t in mesh_runs[4]["twins"]]}),
        twin_entry("aggregate_rows_cols_sharded",
                   "src/repro/kernels/aggregate.py:170",
                   "src/repro_torch/kernels/csrc/aggregate.cu",
                   [t["times"][0] for t in tw2],
                   max(e["cols"] for e in errs_all),
                   {"wrapper": "src/repro_torch/kernels/aggregate.py",
                    "shards": 2, "shape": tw2[0]["times"][0]["shape"],
                    "s4": [t["times"][0] for t in mesh_runs[4]["twins"]]}),
        twin_entry("fused_sgd_sharded",
                   "src/repro/kernels/fused_sgd.py:135",
                   "src/repro_torch/kernels/csrc/fused_sgd.cu",
                   [t["sgd_time"] for t in tw2],
                   max(e["sgd_vs_plain"] for e in errs_all),
                   {"wrapper": "src/repro_torch/kernels/fused_sgd.py",
                    "shards": 2, "shape": {"k": tw2[0]["sgd_time"]["k"],
                                           "with_losses": False},
                    "library_ms": None, "bit_identical_to_kernel": True,
                    "floor": sgd_floor,
                    "s4": [t["sgd_time"] for t in mesh_runs[4]["twins"]]}),
    ]


# ---- phases 22-25: the Table-I arena, the bound, snapshots and resume -----

# the arena's headline cell: benchmarks/arena.py::main's non-IID clean cell
# with benchmarks/common.py::run_mech's settings, copied here (benchmarks/
# imports the JAX package); nothing is cut
ARENA_CFG = dict(n_workers=24, n_rounds=6000, phi=0.4, tau_bound=5, V=10.0,
                 lr=0.1, eval_every=max(6000 // 8, 5), seed=0,
                 target_accuracy=0.55, max_sim_time=4000.0)
ARENA_MECHS = {"dystop": {"V": 10.0, "t_thre": 50, "max_neighbors": 7},
               "matcha": {}, "gossipfl": {}, "asydfl": {"n_neighbors": 7},
               "sa-adfl": {"V": 10.0}}
ARENA_ADFL = ("asydfl", "sa-adfl")     # the headline's ADFL state of the art
# the JAX package's CPU run of the same cell (BENCH_arena.json,
# arena/*/phi0.4/clean): simulated seconds and GB at 0.55, reference values
# printed beside the port's, never as the port's
ARENA_JAX_CPU = {"dystop": (669.4, 4.2), "matcha": (1686.1, 3.8),
                 "gossipfl": (1333.8, 0.9), "asydfl": (1666.8, 2.9),
                 "sa-adfl": (1338.6, 2.2), "time_saved_pct": 50.0,
                 "comm_saved_pct": -93.6}
ARENA_CARD_CPU_TOL = 1e-3          # acc_global, card vs CPU, every eval
SIM_CONTROL = ("rounds", "sim_time", "comm_gb", "round_active",
               "round_durations", "staleness_avg", "staleness_max")
SIM_CURVES = ("acc_global", "acc_local", "loss_global")
RESUME_RTOL, RESUME_ATOL = 1e-6, 1e-7   # tests/test_pipeline.py's resume gate
BOUND_KW = dict(f0_gap=2.0, eta=0.01, mu=0.5, L=1.0)   # Theorem 1 inputs
SIGKILL_CKPT = dict(checkpoint_every=50, scenario="churn20")
LM_CKPT_RTOL = 1e-3                # loss_global, LM resume vs uninterrupted


def sgd_recorder(counter, sgd):
    """A wrapper around ``fused_sgd`` that counts each call's shape."""
    def rec_sgd(buf, xb, yb, active, spec, lr, with_losses=True):
        counter[("fused_sgd", buf.shape[0], bool(with_losses))] += 1
        return sgd(buf, xb, yb, active, spec, lr, with_losses)

    return rec_sgd


def pct_saved(dystop_v, base_v):
    """DySTop's reduction against a baseline in % (``benchmarks/arena.py``'s
    rule); None if either never reached the target."""
    if dystop_v is None or base_v is None or base_v <= 0:
        return None
    return 100.0 * (1.0 - dystop_v / base_v)


def arena_phase() -> tuple:
    """Phase 22: the five Table-I mechanisms on the arena's headline cell,
    each on the card with the counters zeroed (``aggregate`` and
    ``fused_sgd`` must launch), on the CPU (control plane identical,
    ``acc_global`` within ``ARENA_CARD_CPU_TOL`` at every eval) and once
    more on the card under the profiler (busy share over the first card
    run's wall).  Returns the report and each mechanism's kernel shapes."""
    import numpy as np
    import torch
    from repro_torch.core.baselines import get_mechanism
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import fused_sgd as FSGD
    cfg = SimConfig(**ARENA_CFG)
    orig_agg, orig_sgd = AGG.aggregate, FSGD.fused_sgd
    report, shapes_by_mech = {}, {}
    for name, kw in ARENA_MECHS.items():
        shapes: Counter = Counter()
        AGG.aggregate, _ = recorder(shapes, orig_agg)
        FSGD.fused_sgd = sgd_recorder(shapes, orig_sgd)
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            card = run_simulation(get_mechanism(name, **kw), cfg)
        finally:
            AGG.aggregate, FSGD.fused_sgd = orig_agg, orig_sgd
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"aggregate": AGG.launches, "fused_sgd": FSGD.launches}
        check(launches["aggregate"] > 0 and launches["fused_sgd"] > 0,
              f"arena {name}: a kernel never launched: {launches}")
        acc = np.asarray(card.acc_global)
        check(np.isfinite(acc).all() and np.isfinite(card.loss_global).all(),
              f"arena {name}: non-finite accuracy or loss")
        cpu = run_simulation(get_mechanism(name, **kw), cfg, device="cpu")
        for f in SIM_CONTROL:
            check(getattr(card, f) == getattr(cpu, f),
                  f"arena {name}: card and CPU differ in {f}")
        gap = float(np.max(np.abs(acc - np.asarray(cpu.acc_global))))
        check(gap <= ARENA_CARD_CPU_TOL,
              f"arena {name}: card and CPU accuracy differ by {gap}")
        busy_s, top, _ = device_profile(
            lambda: run_simulation(get_mechanism(name, **kw), cfg))
        report[name] = {
            "rounds": len(card.round_durations),
            "sim_time_s": card.sim_time[-1], "comm_gb": card.comm_gb[-1],
            "t_at_target_s": card.completion_time,
            "comm_gb_at_target": card.completion_comm_gb,
            "cpu_t_at_target_s": cpu.completion_time,
            "acc_final": float(acc[-1]), "card_vs_cpu_acc_gap": gap,
            "wall_s": wall, "setup_wall_s": card.setup_wall_s,
            "plan_wall_s": card.plan_wall_s, "eval_wall_s": card.eval_wall_s,
            "device_busy_s": busy_s,
            "device_busy_share": None if busy_s is None else busy_s / wall,
            "device_top_kernels": top, "launches": launches,
            "jax_cpu_reference": {"t_at_target_s": ARENA_JAX_CPU[name][0],
                                  "comm_gb_at_target":
                                      ARENA_JAX_CPU[name][1]}}
        shapes_by_mech[name] = shapes
        print(f"arena {name}: {report[name]['rounds']} rounds, t@0.55 "
              f"{card.completion_time} s, comm@0.55 {card.completion_comm_gb}"
              f" GB, acc {acc[-1]:.4f}, wall {wall:.2f} s, launches "
              f"{launches}, card vs CPU control identical, acc gap "
              f"{gap:.2e}", flush=True)
    dy = report["dystop"]
    best_t = min((report[b]["t_at_target_s"] for b in ARENA_ADFL
                  if report[b]["t_at_target_s"] is not None), default=None)
    best_c = min((report[b]["comm_gb_at_target"] for b in ARENA_ADFL
                  if report[b]["comm_gb_at_target"] is not None),
                 default=None)
    headline = {
        "cell": "phi0.4/clean", "target": ARENA_CFG["target_accuracy"],
        "versus": "best ADFL baseline (asydfl, sa-adfl)",
        "time_saved_pct": pct_saved(dy["t_at_target_s"], best_t),
        "comm_saved_pct": pct_saved(dy["comm_gb_at_target"], best_c),
        "jax_cpu_reference": {
            "time_saved_pct": ARENA_JAX_CPU["time_saved_pct"],
            "comm_saved_pct": ARENA_JAX_CPU["comm_saved_pct"],
            "source": "BENCH_arena.json (the JAX package on a CPU), not the "
                      "port's"},
        "paper": {"time_saved_pct": 51.8, "comm_saved_pct": 57.1}}
    print(f"arena headline: DySTop saves {headline['time_saved_pct']} % "
          f"time and {headline['comm_saved_pct']} % comm against the best "
          f"ADFL baseline (the JAX package's CPU run: 50.0 % / -93.6 %)",
          flush=True)
    return {"mechanisms": report, "headline": headline}, shapes_by_mech


def arena_kernel_rows(shapes_by_mech: dict, gen, spec, dev) -> tuple:
    """The kernels at the arena cell's shapes (each mechanism's two
    commonest ``aggregate`` shapes and its commonest ``fused_sgd`` shape,
    each shape once): held against the plain version, then timed beside it,
    the library call and the bound, as phase 4 times the sim cell's."""
    import torch
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import fused_sgd as FSGD
    n, p = ARENA_CFG["n_workers"], spec.n_params
    steps, batch, lr = 2, 32, ARENA_CFG["lr"]
    X = torch.randn((n, p), generator=gen).to(dev)
    agg_rows, sgd_rows, seen = [], [], set()
    for name, shapes in shapes_by_mech.items():
        aggs = sorted(((s, c) for s, c in shapes.items()
                       if s[0] == "aggregate"), key=lambda sc: -sc[1])
        sgds = sorted(((s, c) for s, c in shapes.items()
                       if s[0] == "fused_sgd"), key=lambda sc: -sc[1])
        for (_, k, u, col), count in aggs[:2]:
            if ("aggregate", k, u, col) in seen:
                continue
            seen.add(("aggregate", k, u, col))
            W, cid = agg_case(gen, k, u, n, col, dev)
            got, want = AGG.aggregate(W, X, cid), AGG.aggregate_plain(W, X,
                                                                      cid)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            lib_cid = None if cid is None else cid.long()
            b_ms, b_by = agg_cost(k, W.cpu(),
                                  None if cid is None else cid.cpu(), p, n)
            agg_rows.append({
                "label": f"arena {name}", "N": n, "k": k, "u": u,
                "col_sparse": col, "launches": count, "max_abs_err": err,
                "ms": device_ms(lambda: AGG.aggregate(W, X, cid)),
                "plain_ms": device_ms(lambda: AGG.aggregate_plain(W, X,
                                                                  cid)),
                "library_ms": device_ms(
                    (lambda: torch.matmul(W, X)) if cid is None else
                    (lambda: torch.matmul(W, X.index_select(0, lib_cid)))),
                "bound_ms": b_ms, "bound_by": b_by})
        for (_, k, with_losses), count in sgds[:1]:
            if ("fused_sgd", k, with_losses) in seen:
                continue
            seen.add(("fused_sgd", k, with_losses))
            buf, xb, yb, active = sgd_case(gen, k, steps, batch, 32, 10, dev,
                                           p)
            out, loss = FSGD.fused_sgd(buf, xb, yb, active, spec, lr,
                                       with_losses)
            ref, ref_loss = FSGD.local_sgd_flat_fused(buf, xb, yb, active,
                                                      spec, lr, with_losses)
            torch.cuda.synchronize()
            err = max(float((out - ref).abs().max()),
                      float((loss - ref_loss).abs().max()))
            torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
            b_ms, b_by = sgd_cost(spec, active, k, steps, batch, with_losses)
            sgd_rows.append({
                "label": f"arena {name}", "k": k, "with_losses": with_losses,
                "launches": count, "max_abs_err": err,
                "ms": device_ms(lambda: FSGD.fused_sgd(
                    buf, xb, yb, active, spec, lr, with_losses)),
                "plain_ms": device_ms(lambda: FSGD.local_sgd_flat_fused(
                    buf, xb, yb, active, spec, lr, with_losses)),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
    for kernel, rows in (("aggregate", agg_rows), ("fused_sgd", sgd_rows)):
        for r in rows:
            print(f"{kernel} at the {r['label']} shape: {r}", flush=True)
    return agg_rows, sgd_rows


def bound_phase() -> dict:
    """Phase 23: DySTop and AsyDFL on the arena cell for 100 rounds with a
    bound log, on the card and on the CPU: Theorem 1's bound over the two
    logs must be equal to the last bit (the log is control plane only)."""
    import numpy as np
    from repro_torch.core import convergence as CV
    from repro_torch.core.baselines import get_mechanism
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    cfg = SimConfig(**dict(ARENA_CFG, n_rounds=100))
    n = cfg.n_workers
    args = dict(alpha=np.full(n, 1.0 / n), xi=np.full(n, 0.5),
                g_star=np.ones(n), **BOUND_KW)
    out = {}
    for name in ("dystop", "asydfl"):
        bounds = []
        for device in ("cuda", "cpu"):
            h = run_simulation(get_mechanism(name, **ARENA_MECHS[name]), cfg,
                               record_history_for_bound=True, device=device)
            log = h.bound_log
            check(len(log["active"]) == 100, f"bound log of {name} has "
                  f"{len(log['active'])} rounds")
            bounds.append(CV.convergence_bound(log["active"], log["W"],
                                               **args))
        check(bounds[0] == bounds[1] and np.isfinite(bounds[0])
              and bounds[0] > 0,
              f"convergence bound of {name}: card {bounds[0]!r}, CPU "
              f"{bounds[1]!r}")
        out[name] = {"rounds": 100, "bound": bounds[0]}
        print(f"bound over 100 rounds, {name}: {bounds[0]!r} on the card "
              f"and the CPU alike", flush=True)
    out["inputs"] = {"alpha": "uniform", "xi": 0.5, "g_star": 1.0,
                     **BOUND_KW}
    return out


def sim_child(ckdir: str) -> int:
    """The checkpointing run that phase 24 kills: ``SimConfig()`` defaults
    with the churn20 scenario, a snapshot every 50 rounds, on the card."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    run_simulation(DySTop(V=10.0, t_thre=20),
                   SimConfig(checkpoint_dir=ckdir, **SIGKILL_CKPT))
    return 0


def sigkill_phase(root: pathlib.Path) -> dict:
    """Phase 24: a child process runs ``sim_child``; once its second
    snapshot exists it gets SIGKILL.  The run resumed on the card from the
    oldest snapshot left must equal an uninterrupted checkpointing run on
    the card: control plane exactly, the curves within rtol 1e-6 / atol
    1e-7."""
    import shutil
    import signal
    import numpy as np
    import torch
    from repro_torch.checkpoint import io as CIO
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    shutil.rmtree(root, ignore_errors=True)
    killed, whole = root / "killed", root / "whole"
    second = CIO.checkpoint_path(killed, 2 * SIGKILL_CKPT["checkpoint_every"])
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable,
                              str(pathlib.Path(__file__).resolve()),
                              "--sim-child", str(killed)])
    try:
        deadline = time.monotonic() + 600
        while not second.exists():
            check(child.poll() is None, f"the checkpointing child exited "
                  f"({child.returncode}) before its second snapshot")
            check(time.monotonic() < deadline, "the checkpointing child "
                  "wrote no second snapshot in 600 s")
            time.sleep(0.001)
        child.send_signal(signal.SIGKILL)
        rc = child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    kill_wall = time.perf_counter() - t0
    kept = CIO.list_checkpoints(killed)
    n_rounds = SimConfig().n_rounds
    check(rc == -signal.SIGKILL, f"the child was not killed (exit {rc})")
    check(bool(kept) and kept[-1] != CIO.checkpoint_path(killed, n_rounds),
          f"the killed run finished before the kill: {kept}")
    mech = lambda: DySTop(V=10.0, t_thre=20)        # noqa: E731
    zero_counters()
    t0 = time.perf_counter()
    res = run_simulation(mech(), SimConfig(checkpoint_dir=str(killed),
                                           **SIGKILL_CKPT),
                         resume_from=str(kept[0]))
    torch.cuda.synchronize()
    resume_wall = time.perf_counter() - t0
    launches = read_counters()
    check(launches["aggregate"] > 0 and launches["fused_sgd"] > 0,
          f"the resumed run launched no kernel: {launches}")
    ref = run_simulation(mech(), SimConfig(checkpoint_dir=str(whole),
                                           **SIGKILL_CKPT))
    for f in SIM_CONTROL:
        check(getattr(res, f) == getattr(ref, f),
              f"resume after SIGKILL: {f} differs from the uninterrupted run")
    gaps = {}
    for f in SIM_CURVES:
        a, b = np.asarray(getattr(res, f)), np.asarray(getattr(ref, f))
        check(np.allclose(a, b, rtol=RESUME_RTOL, atol=RESUME_ATOL),
              f"resume after SIGKILL: {f} off the uninterrupted run by "
              f"{np.abs(a - b).max()}")
        gaps[f] = float(np.abs(a - b).max())
    bit_equal = all(getattr(res, f) == getattr(ref, f) for f in SIM_CURVES)
    out = {"config": "SimConfig() defaults, scenario churn20, "
                     "checkpoint_every=50, DySTop(V=10.0, t_thre=20)",
           "child_exit": rc, "snapshots_left": [p.name for p in kept],
           "resumed_from": kept[0].name, "kill_wall_s": kill_wall,
           "resume_wall_s": resume_wall, "launches": launches,
           "max_curve_gaps": gaps, "curves_bit_equal": bit_equal}
    shutil.rmtree(root, ignore_errors=True)
    print(f"SIGKILL resume: child killed after {kept[-1].name}, resumed "
          f"from {kept[0].name}: control plane identical, curves "
          f"{'bit-equal' if bit_equal else gaps}", flush=True)
    return out


def lm_snapshot_phase(root: pathlib.Path) -> dict:
    """Phase 25: smollm-135m at full width, 2 workers, 6 rounds, a snapshot
    every 3 rounds; resume from round 3 (control plane exactly,
    ``loss_global`` within rtol ``LM_CKPT_RTOL``); serve 8 greedy requests
    from the round-6 snapshot through ``serving.bridge`` for worker 0 and
    for the Eq. 11 global model, the served parameters the snapshot's row
    bit for bit.  The snapshots are deleted afterwards."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import io as CIO
    from repro_torch.configs import smollm_135m
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import flat_state as FS
    from repro_torch.dfl import lm_worker as LW
    from repro_torch.serving import bridge as BR
    from repro_torch.tree import tree_paths
    cfg = smollm_135m.get_config()
    spec = BR.fleet_spec_for(cfg)
    p = spec.n_params
    snap_bytes = 2 * 3 * p * 4          # pbuf and Adam's two moments, f32
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    need = 3 * snap_bytes + (1 << 30)   # two snapshots and one being written
    check(free >= need, f"phase 25 needs {need / 1e9:.1f} GB of free disk "
          f"under {root}, found {free / 1e9:.1f} GB")
    run = LW.LMRunConfig(n_workers=2, n_rounds=6, batch=4, seq=256,
                         optimizer="adam", lr=1e-3, eval_every=5,
                         checkpoint_every=3, checkpoint_dir=str(root))
    mech = lambda: DySTop(V=3.0, t_thre=10, max_neighbors=3)   # noqa: E731
    try:
        t0 = time.perf_counter()
        _, whole = LW.run_lm_federation(mech(), cfg, run)
        torch.cuda.synchronize()
        whole_wall = time.perf_counter() - t0
        snaps = CIO.list_checkpoints(root)
        check([s.name for s in snaps] == ["ckpt_round000003.npz",
                                          "ckpt_round000006.npz"],
              f"LM snapshots: {[s.name for s in snaps]}")
        sizes = [s.stat().st_size for s in snaps]
        torch.cuda.empty_cache()
        zero_counters()
        t0 = time.perf_counter()
        _, res = LW.run_lm_federation(mech(), cfg, run, str(snaps[0]))
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t0
        launches = read_counters()
        check(launches["flash_attention"] > 0 and launches["aggregate"] > 0,
              f"the resumed LM run launched no kernel: {launches}")
        for f in ("rounds", "sim_time", "comm_gb", "round_active",
                  "round_durations", "staleness_avg", "staleness_max"):
            check(getattr(res, f) == getattr(whole, f),
                  f"LM resume: {f} differs from the uninterrupted run")
        lg_a, lg_b = np.asarray(res.loss_global), np.asarray(whole.loss_global)
        check(np.isfinite(lg_a).all()
              and np.allclose(lg_a, lg_b, rtol=LM_CKPT_RTOL, atol=0),
              f"LM resume: loss_global {lg_a.tolist()} vs {lg_b.tolist()}")
        torch.cuda.empty_cache()
        # serve from the round-6 snapshot (the resumed run's)
        ck = CIO.checkpoint_path(root, 6)
        blobs, _ = CIO.read_checkpoint(ck, ("params|pbuf",))
        row0 = torch.from_numpy(blobs.pop("params|pbuf")[0].copy()).cuda()
        served = BR.serving_params_from_checkpoint(ck, cfg, worker=0)
        want = FS.unravel_tree(row0, spec, copy=True)
        for (pa, a), (pb, b) in zip(tree_paths(served), tree_paths(want)):
            check(pa == pb and a.dtype == b.dtype and torch.equal(a, b),
                  f"served leaf {pa} differs from the snapshot's row")
        again = torch.empty_like(row0)
        FS.ravel_tree_into(served, spec, again)
        check(torch.equal(again.view(torch.int32), row0.view(torch.int32)),
              "the snapshot's f32 row does not hold its bf16 leaves exactly")
        del served, want, again, row0
        reqs = serve_requests(cfg, 8, 31)
        served_tokens = {}
        t0 = time.perf_counter()
        for label, worker in (("worker 0", 0), ("global", None)):
            eng = BR.engine_from_checkpoint(ck, cfg, worker=worker,
                                            batch_slots=8, max_len=512)
            rids = [eng.submit(r.prompt, r.gen) for r in reqs]
            out = eng.run()
            check(all(len(out[i]) == r.gen.max_new_tokens
                      for i, r in zip(rids, reqs)),
                  f"serving from the snapshot ({label}): a request did not "
                  f"complete")
            served_tokens[label] = sum(len(out[i]) for i in rids)
            del eng
            torch.cuda.empty_cache()
        serve_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"config": "smollm-135m get_config() (30 layers), LMRunConfig("
                     "n_workers=2, n_rounds=6, batch=4, seq=256, adam, "
                     "lr=1e-3, eval_every=5, checkpoint_every=3), "
                     "DySTop(V=3.0, t_thre=10, max_neighbors=3)",
           "P": p, "snapshot_bytes": sizes, "whole_wall_s": whole_wall,
           "resume_wall_s": resume_wall, "launches": launches,
           "loss_global": lg_a.tolist(),
           "loss_bit_equal": bool(np.array_equal(lg_a, lg_b)),
           "served_tokens": served_tokens, "serve_wall_s": serve_wall,
           "disk_free_bytes": free}
    print(f"LM snapshot: resumed from round 3 on the uninterrupted control "
          f"plane, loss_global {lg_a.tolist()}; served 8 requests from the "
          f"round-6 snapshot for worker 0 and the global model "
          f"({served_tokens}); snapshots {sizes} bytes, deleted", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    # phase 9's flex_attention yardstick is compiled in this process, its
    # caches inside the checkout's build/ (which .gitignore lists)
    build_dir = pathlib.Path(__file__).resolve().parent / "build"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(build_dir / "torchinductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build_dir / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    import numpy as np
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import flat_state as FS
    from repro_torch.dfl import worker as WK
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    from repro_torch.kernels import _build
    from repro_torch.configs import gemma2_2b, mamba2_2_7b, smollm_135m
    from repro_torch.dfl import lm_worker as LW
    from repro_torch.kernels import aggregate as AGG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_sgd as FSGD
    from repro_torch.kernels import ssd_chunk as SC
    from repro_torch.configs import grok_1_314b
    from repro_torch.kernels import moe_router as MR
    from repro_torch.models import registry as R
    from repro_torch.serving import (ARRIVAL_PRESETS, ServeEngine, drive,
                                     generate_requests)
    from repro_torch.tree import tree_leaves

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
    # k past 8 rows of a block and every P % 4 (the load width follows P
    # and the base address): the plain version's values, and the bits the
    # 4-wide loads give on the same columns
    wide = torch.randn((N_WORKERS, 6924), generator=gen).to(dev)
    flat = torch.empty((N_WORKERS * 6920 + 1,), device=dev)
    x_cases = [(f"P={p_}", wide[:, :p_].contiguous())
               for p_ in (6920, 6921, 6922, 6923)]
    x_cases.append(("P=6920, base 4 bytes off 16", flat[1:].view(N_WORKERS,
                                                                 6920)))
    x_cases[-1][1].copy_(wide[:, :6920])
    n_width = 0
    for k in (8, 100, 128, 200):
        for col in (True, False):
            W, cid = agg_case(gen, k, 64 if col else N_WORKERS, N_WORKERS,
                              col, dev)
            ref = AGG.aggregate(W, wide, cid)
            for label, Xp in x_cases:
                got = AGG.aggregate(W, Xp, cid)
                want = AGG.aggregate_plain(W, Xp, cid)
                torch.cuda.synchronize()
                agg_err = max(agg_err, float((got - want).abs().max()))
                torch.testing.assert_close(
                    got, want, atol=1e-5, rtol=1e-5,
                    msg=lambda m: f"aggregate k={k} {label}: {m}")
                check(torch.equal(got.view(torch.int32),
                                  ref[:, :Xp.shape[1]].view(torch.int32)),
                      f"aggregate's bits change with the load width at "
                      f"k={k}, {label}, col_sparse={col}")
                n_width += 1
    W, cid = agg_case(gen, 100, 64, N_WORKERS, True, dev)
    bad = cid.clone()
    bad[5] = N_WORKERS
    check(bool(torch.isnan(AGG.aggregate(W, X, bad)).all()),
          "aggregate: an out-of-range column id did not turn the outputs NaN")
    del wide, flat, x_cases
    print(f"aggregate: {n_width} cases at k in 8..200, P % 4 in 0..3 and a "
          f"misaligned base match the plain version with the 4-wide bits, "
          f"an out-of-range id gives NaN, max |err| {agg_err:.3e}",
          flush=True)

    sgd_err = 0.0
    steps, batch = cfg.local_steps, cfg.batch_size
    n_sgd = 0
    # the path's MLP at k in {8, 16, 100}, a batch the cluster does not
    # divide, widths other than the default and 50 steps (each step's
    # minibatch is copied in while the step before runs)
    odd_spec = FS.spec_of(mlp_stacked(20, 48, 36, 7))
    sgd_cases = [(k, batch, spec, steps) for k in (8, 16, N_WORKERS)]
    sgd_cases += [(N_WORKERS, 30, spec, steps),
                  (N_WORKERS, batch, odd_spec, steps), (8, batch, spec, 50)]
    for k, b_, sp, st in sgd_cases:
        d_, c_ = sp.shapes[sp.keys.index("w1")][0], sp.shapes[-1][-1]
        for with_losses in (True, False):
            buf, xb, yb, active = sgd_case(gen, k, st, b_, d_, c_, dev,
                                           sp.n_params)
            out, loss = FSGD.fused_sgd(buf, xb, yb, active, sp, cfg.lr,
                                       with_losses=with_losses)
            ref, ref_loss = FSGD.local_sgd_flat_fused(
                buf, xb, yb, active, sp, cfg.lr, with_losses=with_losses)
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
            # the same bits on a second launch, and a row's bits alone equal
            # its bits among k rows
            again, again_loss = FSGD.fused_sgd(buf, xb, yb, active, sp,
                                               cfg.lr, with_losses)
            check(torch.equal(out, again) and torch.equal(loss, again_loss),
                  f"fused_sgd k={k} batch={b_}: a second launch gave other "
                  f"bits")
            for i in sorted({0, k // 3, k - 1}):
                one, one_loss = FSGD.fused_sgd(
                    buf[i:i + 1], xb[i:i + 1], yb[i:i + 1], active[i:i + 1],
                    sp, cfg.lr, with_losses)
                check(torch.equal(one[0], out[i])
                      and torch.equal(one_loss[0], loss[i]),
                      f"fused_sgd: row {i}'s bits alone differ from its bits "
                      f"among k={k} (batch {b_})")
            n_sgd += 1
    sgd_smem = FSGD.smem_bytes(batch, cfg.dim, cfg.hidden, cfg.hidden, 10)
    print(f"fused_sgd: {n_sgd} cases (k in 8..100, batch 30, widths "
          f"20-48-36-7, 50 steps) match the plain version, max |err| "
          f"{sgd_err:.3e}; "
          f"the same bits on a second launch and for rows alone; "
          f"{FSGD.cluster_size(batch)} CTAs per row, {sgd_smem} B of shared "
          f"memory each", flush=True)

    # ---- 2b. aggregate past 2^31 columns -----------------------------------
    big_p = 2 ** 31 + 4096
    Xb = torch.empty((2, big_p), device=dev)
    Xb.normal_(generator=torch.Generator(dev).manual_seed(7))
    Wb = torch.rand((2, 2), generator=gen).to(dev)
    windows = (0, 2 ** 31 - 2048, big_p - 4096)
    Yb = AGG.aggregate(Wb, Xb)
    torch.cuda.synchronize()
    big_err = 0.0
    for lo in windows:
        got = Yb[:, lo:lo + 4096]
        want = AGG.aggregate_plain(Wb, Xb[:, lo:lo + 4096].contiguous())
        check(bool(torch.isfinite(got).all()),
              f"aggregate past 2^31 columns: non-finite at column {lo}")
        big_err = max(big_err, float((got - want).abs().max()))
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    del Yb, got
    bb_ms, bb_by = agg_cost(2, Wb.cpu(), None, big_p, 2)
    big_row = {"label": "past 2^31 columns", "k": 2, "u": 2,
               "col_sparse": False, "P": big_p, "max_abs_err": big_err,
               "ms": device_ms(lambda: AGG.aggregate(Wb, Xb), reps=3),
               "bound_ms": bb_ms, "bound_by": bb_by}
    agg_err = max(agg_err, big_err)
    del Xb, Wb
    torch.cuda.empty_cache()
    print(f"aggregate past 2^31 columns (k=2, N=2, P={big_p}): windows at "
          f"0, 2^31 - 2048 and P - 4096 match the plain version, max |err| "
          f"{big_err:.3e}; {big_row['ms']:.3f} ms, bound {bb_ms:.3f} ms "
          f"({bb_by})", flush=True)

    # ---- 3. the main path, through the kernels -----------------------------
    shapes: Counter = Counter()
    orig_agg, orig_sgd = AGG.aggregate, FSGD.fused_sgd
    orig_fa = FA.flash_attention
    rec_agg, _ = recorder(shapes, orig_agg)
    AGG.aggregate, FSGD.fused_sgd = rec_agg, sgd_recorder(shapes, orig_sgd)
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
            "label": "sim", "k": k, "u": u, "col_sparse": col,
            "rounds": count,
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
    # what this timing cannot go below: a call with next to no work, and one
    # PyTorch elementwise launch
    W1, X1 = torch.ones((1, 1), device=dev), torch.ones((1, 128), device=dev)
    agg_floor = {"ms": device_ms(lambda: AGG.aggregate(W1, X1)),
                 "torch_add_ms": device_ms(lambda: X1.add_(0.0))}
    sgd_shapes = sorted(((s, c) for s, c in shapes.items()
                         if s[0] == "fused_sgd"), key=lambda sc: -sc[1])
    # the path's shapes first (commonest first), then the rest of k in
    # {8, 16, 100} with losses on and off; beside each, the floor of this
    # timing for fused_sgd (one row, one step of a 1-1-1-2 MLP: at batch 1
    # a one-CTA launch with next to no work, at batch 4 a 4-CTA cluster
    # with next to no work) and one PyTorch launch
    tiny_spec = FS.spec_of(mlp_stacked(1, 1, 1, 2))
    tiny = sgd_case(gen, 1, 1, 1, 1, 2, dev, tiny_spec.n_params)
    tiny4 = sgd_case(gen, 1, 1, 4, 1, 2, dev, tiny_spec.n_params)
    sgd_floor = {"ms": device_ms(lambda: FSGD.fused_sgd(
        *tiny, tiny_spec, cfg.lr, False)),
        "cluster4_ms": device_ms(lambda: FSGD.fused_sgd(
            *tiny4, tiny_spec, cfg.lr, False)),
        "torch_add_ms": agg_floor["torch_add_ms"]}
    sgd_keys = [s[1:] for s, _ in sgd_shapes]
    sgd_keys += [(k, wl) for k in (8, 16, N_WORKERS) for wl in (False, True)
                 if (k, wl) not in sgd_keys]
    sgd_rows = []
    for k, with_losses in sgd_keys:
        buf, xb, yb, active = sgd_case(gen, k, steps, batch, cfg.dim,
                                       10, dev, P)
        b_ms, b_by = sgd_cost(spec, active, k, steps, batch, with_losses)
        sgd_rows.append({
            "k": k, "with_losses": with_losses,
            "rounds": shapes[("fused_sgd", k, with_losses)],
            "ms": device_ms(lambda: FSGD.fused_sgd(
                buf, xb, yb, active, spec, cfg.lr, with_losses)),
            "plain_ms": device_ms(lambda: FSGD.local_sgd_flat_fused(
                buf, xb, yb, active, spec, cfg.lr, with_losses)),
            "call_ms": call_ms(lambda: FSGD.fused_sgd(
                buf, xb, yb, active, spec, cfg.lr, with_losses)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "floor_ms": sgd_floor["ms"],
            "floor_cluster4_ms": sgd_floor["cluster4_ms"],
            "torch_add_ms": sgd_floor["torch_add_ms"]})
        r_ = sgd_rows[-1]
        print(f"fused_sgd k={k} losses={'on' if with_losses else 'off'} "
              f"({r_['rounds']} rounds): {r_['ms']:.5f} ms, plain "
              f"{r_['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by}), floor "
              f"{sgd_floor['ms']:.5f} ms (4-CTA cluster "
              f"{sgd_floor['cluster4_ms']:.5f}, a PyTorch launch "
              f"{sgd_floor['torch_add_ms']:.5f})", flush=True)

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
    both, bf16_only = (torch.bfloat16, torch.float32), (torch.bfloat16,)
    fa_cases = [("path", (4, 9, 256, 64), 3, True, None, None, both),
                ("ragged S=200", (4, 9, 200, 64), 3, True, None, None, both),
                ("window 64", (4, 9, 256, 64), 3, True, 64, None, both),
                ("softcap 50", (4, 9, 256, 64), 3, True, None, 50.0, both),
                ("(1, 8, 1024, 128)", (1, 8, 1024, 128), 8, True, None, None,
                 both),
                ("window 0: all rows masked", (2, 4, 96, 64), 2, True, 0,
                 None, both),
                ("non-causal window -32: last rows masked", (2, 4, 160, 64),
                 2, False, -32, None, both),
                # the bf16 kernel's lifted limits (the f32 kernel refuses
                # these three)
                ("D=112 (kimi-k2)", (2, 8, 200, 112), 1, True, None, None,
                 bf16_only),
                ("D=32 (smoke widths)", (2, 4, 96, 32), 2, True, None, None,
                 bf16_only),
                ("B=70000 (past grid z)", (70000, 1, 16, 64), 1, True, None,
                 None, bf16_only),
                ("D=256 (bf16: two warpgroups), S=950, window 300, "
                 "softcap 30", (8, 8, 950, 256), 4, True, 300, 30.0, both)]
    for label, (b, h, s, d), hk, causal, window, softcap, dtypes in fa_cases:
        for dtype in dtypes:
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
            del q, k, v, got, want
        if dtypes == bf16_only:
            try:
                FA.check_sizes(b, h, s, d, torch.float32)
            except ValueError:
                pass
            else:
                raise RuntimeError(f"chip_smoke: the f32 kernel took {label}")
    # TMA needs 16-byte-aligned bases and strides: such a bf16 call raises
    # before any launch, and never falls back
    before = FA.launches
    wide = torch.randn((2, 4, 96, 65), generator=gen).to(dev, torch.bfloat16)
    flat = torch.randn((2 * 4 * 96 * 64 + 1,), generator=gen).to(
        dev, torch.bfloat16)
    for label, bad in (("rows 130 bytes apart", wide[..., :64]),
                       ("base off by 2 bytes",
                        flat[1:].view(2, 4, 96, 64))):
        try:
            FA.flash_attention(bad, bad, bad)
        except ValueError as e:
            check("16" in str(e), f"flash misaligned ({label}): {e}")
        else:
            raise RuntimeError(f"chip_smoke: flash took a misaligned bf16 "
                               f"input ({label})")
    check(FA.launches == before, "flash launched on a misaligned input")
    print("flash: misaligned bf16 inputs raise (strides, base)")
    del wide, flat
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
        "bound_ms": fb_ms, "bound_by": fb_by, "max_bf16_ulps": ulps,
        "library_bf16_ulps": bf16_ulps(
            torch.nn.functional.scaled_dot_product_attention(
                q, k_rep, v_rep, is_causal=causal).float(), want.float())}
    lm_agg_row = lm_aggregate_row(gen, lm_shapes, lm_launches["aggregate"],
                                  fleet.pbuf, "LM")
    agg_err = max(agg_err, lm_agg_row["max_abs_err"])
    del fleet
    # flash at two published attention widths at S = 4096, beside the path's
    g_att, m_att = grok_1_314b.get_config(), gemma2_2b.get_config()
    flash_rows = [dict(flash_row, label="LM path (smollm-135m)")]
    for label, cfg_, softcap_, window_ in (
            ("grok-1-314b widths, no softcap", g_att, None, None),
            ("gemma2-2b widths, softcap, window", m_att,
             m_att.attn_logit_softcap, m_att.window_size)):
        flash_rows.append(flash_long_row(
            gen, dev, label, 1 if cfg_ is g_att else 2, cfg_.n_heads,
            cfg_.n_kv_heads, 4096, cfg_.resolved_head_dim, softcap_,
            window_))
        flash_ulps = max(flash_ulps, flash_rows[-1]["max_bf16_ulps"])
        print(f"flash {label}: {flash_rows[-1]}", flush=True)
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
    # cum_la that rises, which the model never feeds but the plain version
    # takes: a falling wave that rises in places, and a spike to 100 at the
    # second query tile's first row, where a decay split at that row would
    # overflow (exp(100)) in rows whose plain values are finite; rows the
    # plain version gives non-finite (the spike's own) are left out
    Bc, Cc, _, xb = ssd_case(gen, 2, 8, 256, 128, 64, 0.1, dev)
    qs = torch.arange(256, dtype=torch.float32)
    wave = (torch.sin(qs / 8) - 0.08 * qs).expand(2, 8, 256).contiguous()
    spike = torch.zeros((2, 8, 256))
    spike[..., 64] = 100.0
    spike[..., 65:] = -2.0 - 0.08 * (qs[65:] - 64)
    for label, la_, n_bad in (("cum_la a wave", wave, 0),
                              ("cum_la spiking at q = 64", spike, 16)):
        la_ = la_.to(dev)
        got = SC.ssd_chunk(Bc, Cc, la_, xb)
        want = SC.ssd_chunk_plain(Bc, Cc, la_, xb)
        torch.cuda.synchronize()
        rows = torch.isfinite(want).all(-1)
        check(int((~rows).sum()) == n_bad,
              f"ssd {label}: {int((~rows).sum())} non-finite plain rows")
        check(bool(torch.isfinite(got[rows]).all()),
              f"ssd {label}: non-finite where the plain version is finite")
        err = float((got[rows] - want[rows]).abs().max())
        ssd_err = max(ssd_err, err)
        torch.testing.assert_close(got[rows], want[rows], atol=2e-4,
                                   rtol=2e-4)
        print(f"ssd_chunk {label}: max |err| {err:.3e} (relative to the "
              f"largest value {float(want[rows].abs().max()):.3e})",
              flush=True)
    del ins, got, want, Bc, Cc, xb

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
    torch.cuda.empty_cache()

    # ---- 15. the moe_router kernel against its plain version --------------
    router_err = 0.0
    router_cases = [(t_, e_, k_, False) for t_, e_, k_ in (
        (8, 8, 2), (4096, 8, 2), (4096, 384, 8), (300, 8, 2))]
    # grok's E = 8 (four rows share a warp) and E = 16 (two) with every row
    # a tie
    router_cases += [(64, 8, 2, True), (64, 16, 4, True)]
    for t_, e_, k_, ties in router_cases:
        x = (router_tie_logits(t_, e_, dev) if ties
             else router_logits(gen, t_, e_, dev))
        gates, ids = MR.moe_router(x, k_)
        p_gates, p_ids = MR.moe_router_plain(x, k_)
        torch.cuda.synchronize()
        check(torch.equal(ids, p_ids), f"moe_router ({t_}, {e_}, {k_}): ids "
              f"differ from the plain version's")
        check(bool(torch.isfinite(gates).all()),
              f"moe_router ({t_}, {e_}, {k_}): non-finite gates")
        err = float((gates - p_gates).abs().max())
        check(err <= 1e-6, f"moe_router ({t_}, {e_}, {k_}): |err| {err}")
        router_err = max(router_err, err)
        tie_note = ", every row a tie" if ties else ""
        print(f"moe_router ({t_}, {e_}, {k_}{tie_note}): ids identical, max "
              f"|gate err| {err:.3e}", flush=True)

    # ---- 16. serving grok-1-314b at full width, through the kernels -------
    for mod in (AGG, FSGD, FA, SC, MR):
        mod.launches = 0
    g_cfg = dataclasses.replace(grok_1_314b.get_config(), n_layers=4)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_params = R.init_params(g_cfg, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    g_init_wall = time.perf_counter() - t0
    g_init_peak = torch.cuda.max_memory_allocated()
    g_reqs = generate_requests(ARRIVAL_PRESETS["steady"], g_cfg.vocab_size)
    g_eng = ServeEngine(g_cfg, g_params, batch_slots=8, max_len=512, seed=0,
                        device="cuda")
    finite, step_s = [], []
    step = g_eng.step

    def timed_step():
        t1 = time.perf_counter()
        events = step()
        finite.append(torch.isfinite(g_eng.last_logits).all())
        step_s.append(time.perf_counter() - t1)
        return events

    g_eng.step = timed_step
    t0 = time.perf_counter()
    g_rep = drive(g_eng, g_reqs)
    torch.cuda.synchronize()
    g_wall = time.perf_counter() - t0
    g_peak = torch.cuda.max_memory_allocated()
    g_ticks = g_eng.t
    g_launches = {"moe_router": MR.launches, "flash_attention": FA.launches,
                  "ssd_chunk": SC.launches, "aggregate": AGG.launches,
                  "fused_sgd": FSGD.launches}
    check(g_rep.n_finished == len(g_reqs) == 24,
          f"grok served {g_rep.n_finished} of {len(g_reqs)} requests")
    for rid, r in enumerate(g_reqs):
        check(len(g_rep.outputs[rid]) == r.gen.max_new_tokens,
              f"grok request {rid}: {len(g_rep.outputs[rid])} tokens of "
              f"{r.gen.max_new_tokens}")
    check(bool(torch.stack(finite).all()), "grok logits not finite")
    check(g_launches["moe_router"] == g_cfg.n_layers * g_ticks,
          f"moe_router launched {g_launches['moe_router']} times in "
          f"{g_ticks} ticks of {g_cfg.n_layers} MoE layers")
    check(all(g_launches[k] == 0 for k in ("flash_attention", "ssd_chunk",
                                           "aggregate", "fused_sgd")),
          f"a kernel off the serving path launched: {g_launches}")
    g_tick_ms = sum(step_s) / g_ticks * 1e3
    print(f"grok serving (4 layers): {g_rep.n_finished} requests, "
          f"{g_rep.total_tokens} tokens in {g_rep.makespan_s:.2f} s "
          f"({g_rep.tokens_per_sec:.1f} tok/s), {g_ticks} ticks at "
          f"{g_tick_ms:.2f} ms, launches {g_launches}, init "
          f"{g_init_wall:.2f} s, peak {g_peak / 1e9:.2f} GB", flush=True)
    prof_rep = []

    def second_drive():
        eng = ServeEngine(g_cfg, g_params, batch_slots=8, max_len=512,
                          seed=0, device="cuda")
        t1 = time.perf_counter()
        prof_rep.append(drive(eng, g_reqs))
        torch.cuda.synchronize()
        prof_rep.append(time.perf_counter() - t1)

    g_busy, g_top, g_extra = device_profile(second_drive)
    check(prof_rep[0].outputs == g_rep.outputs,
          "the profiled drive served other tokens")

    # ---- 17. moe_router timed at the path's shape and kimi's --------------
    router_rows = []
    x1 = torch.ones((1, 1), device=dev)          # a call with no work
    router_floor = {"ms": device_ms(lambda: MR.moe_router(x1, 1)),
                    "torch_add_ms": agg_floor["torch_add_ms"]}
    for t_, e_, k_ in ((8, 8, 2), (4096, 384, 8)):
        x = router_logits(gen, t_, e_, dev)
        rb_ms, rb_by = router_cost(t_, e_, k_)
        router_rows.append({
            "shape": [t_, e_, k_],
            "ms": device_ms(lambda: MR.moe_router(x, k_)),
            "plain_ms": device_ms(lambda: MR.moe_router_plain(x, k_)),
            "call_ms": call_ms(lambda: MR.moe_router(x, k_)),
            "bound_ms": rb_ms, "bound_by": rb_by, "library_ms": None,
            "floor_ms": router_floor["ms"]})
        print(f"moe_router at ({t_}, {e_}, {k_}): "
              f"{router_rows[-1]['ms']:.5f} ms, plain "
              f"{router_rows[-1]['plain_ms']:.4f} ms, bound {rb_ms:.6f} ms "
              f"({rb_by}), floor {router_floor['ms']:.5f} ms", flush=True)
    del g_eng, g_params
    torch.cuda.empty_cache()

    # ---- 18. the card and the CPU agree on serving -------------------------
    serve_gaps = {label: serve_card_vs_cpu(c, label) for label, c in (
        ("grok", grok_1_314b.get_smoke_config()),
        ("smollm", smollm_135m.get_smoke_config()),
        ("mamba2", mamba2_2_7b.get_smoke_config()))}

    # ---- 19-21. the fleet mesh: gloo ranks sharing the card ----------------
    from repro_torch.launch import mesh as MESH
    lm10 = dataclasses.replace(lm_run, n_rounds=10)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm10_fleet, lm10_hist = LW.run_lm_federation(lm_mech(), lm_cfg, lm10)
    torch.cuda.synchronize()
    lm10_wall = time.perf_counter() - t0
    del lm10_fleet
    torch.cuda.empty_cache()
    col_top = next(s_ for s_, _ in agg_shapes if s_[3])
    row_top = next((s_ for s_, _ in agg_shapes if not s_[3]),
                   ("aggregate", N_WORKERS, N_WORKERS, False))
    plan_base = dict(device="cuda", n=N_WORKERS, P=P, reps=20,
                     buckets=buckets, dim=cfg.dim, hidden=cfg.hidden,
                     steps=steps, batch=batch, lr=cfg.lr,
                     sgd_ks=(8, 16, N_WORKERS),
                     agg_top=[tuple(col_top[1:]), tuple(row_top[1:])],
                     sgd_top=sgd_shapes[0][0][1], sim_cfg=cfg)
    mesh_runs = {}
    for n_sh in MESH_SHARDS:
        plan = dict(plan_base)
        if n_sh == 2:
            plan["lm_twin"] = dict(n=lm_run.n_workers, P=lm_agg_row["P"],
                                   row_ids=[2, 5], reps=3)
            plan["lm"] = (lm_cfg, lm10)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = MESH.spawn(mesh_rank, n_sh, plan, device="cuda")
        spawn_wall = time.perf_counter() - t0
        mesh_runs[n_sh] = mesh_checks(n_sh, ranks, spawn_wall, hist,
                                      lm10_hist, lm10_wall, lm_run.n_workers,
                                      lm_agg_row["P"])
        del ranks

    # ---- 22. the arena's headline cell: the five Table-I mechanisms ------
    torch.cuda.empty_cache()
    arena, arena_shapes = arena_phase()
    arena_agg_rows, arena_sgd_rows = arena_kernel_rows(arena_shapes, gen,
                                                       spec, dev)

    # ---- 23. the convergence bound, card vs CPU ---------------------------
    bound = bound_phase()

    # ---- 24. a SIGKILL mid-run, and the resume -----------------------------
    sigkill = sigkill_phase(build_dir / "chip_smoke_sigkill")

    # ---- 25. LM snapshot -> resume -> serve --------------------------------
    torch.cuda.empty_cache()
    lm_snap = lm_snapshot_phase(build_dir / "chip_smoke_lm_snapshots")

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
         "lm": lm_agg_row,
         "shapes": agg_rows + [lm_agg_row, m_agg_row, big_row],
         "arena_shapes": arena_agg_rows,
         "arena_launches": {m: r["launches"]["aggregate"]
                            for m, r in arena["mechanisms"].items()},
         "floor": agg_floor},
        {"name": "fused_sgd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_sgd.cu",
         "replaces": "src/repro/kernels/fused_sgd.py:112",
         "launches": launches["fused_sgd"], "max_abs_err": sgd_err,
         "shape": {k: top_sgd[k] for k in ("k", "with_losses")},
         "ms": top_sgd["ms"], "kernel_ms": top_sgd["ms"],
         "plain_ms": top_sgd["plain_ms"], "bound_ms": top_sgd["bound_ms"],
         "bound_by": top_sgd["bound_by"], "library_ms": None,
         "call_ms": top_sgd["call_ms"], "floor": sgd_floor,
         "shapes": sgd_rows, "arena_shapes": arena_sgd_rows,
         "arena_launches": {m: r["launches"]["fused_sgd"]
                            for m, r in arena["mechanisms"].items()}},
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
         "call_ms": flash_row["call_ms"],
         "shapes": [{k: r[k] for k in (
             "label", "shape", "kv_heads", "causal", "window", "softcap",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library", "max_bf16_ulps", "library_bf16_ulps") if k in r}
             for r in flash_rows]},
        {"name": "ssd_chunk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd_chunk.py:62",
         "launches": m_launches["ssd_chunk"], "max_abs_err": ssd_err,
         "shape": {"G_H_Q_N_P": ssd_row["shape"]},
         "ms": ssd_row["ms"], "kernel_ms": ssd_row["ms"],
         "plain_ms": ssd_row["plain_ms"], "bound_ms": ssd_row["bound_ms"],
         "bound_by": ssd_row["bound_by"], "library_ms": None,
         "call_ms": ssd_row["call_ms"]},
        {"name": "moe_router", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_router.cu",
         "replaces": "src/repro/kernels/moe_router.py:49",
         "launches": g_launches["moe_router"], "max_abs_err": router_err,
         "shape": {"T_E_k": router_rows[0]["shape"]},
         "ms": router_rows[0]["ms"], "kernel_ms": router_rows[0]["ms"],
         "plain_ms": router_rows[0]["plain_ms"],
         "bound_ms": router_rows[0]["bound_ms"],
         "bound_by": router_rows[0]["bound_by"], "library_ms": None,
         "call_ms": router_rows[0]["call_ms"], "kimi": router_rows[1],
         "floor": router_floor},
    ]
    kernels += mesh_kernel_rows(mesh_runs, sgd_floor)
    print(json.dumps({"mesh": {
        "backend": "gloo", "device": "cuda:0 shared by every rank",
        "sim_config": "SimConfig() defaults with mesh_shards=S, "
                      "DySTop(V=10.0, t_thre=20)",
        "lm_config": "phase 8's smollm-135m config at n_rounds=10, "
                     "mesh_shards=2",
        "unsharded_sim_wall_s": sim_wall,
        "shards": {str(k_): {**v, "twins": [t["max_abs_err"]
                                            for t in v["twins"]]}
                   for k_, v in mesh_runs.items()}}}))
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
    print(json.dumps({"serving": {
        "config": "grok-1-314b get_config() at n_layers=4 (of 64), "
                  "ServeEngine(batch_slots=8, max_len=512, seed=0), "
                  "ARRIVAL_PRESETS['steady'] on the wall clock",
        "params": sum(t.numel() for t in tree_leaves(R.init_params(
            g_cfg, None))),
        "init_wall_s": g_init_wall, "init_peak_bytes": g_init_peak,
        "max_memory_allocated_bytes": g_peak, "drive_wall_s": g_wall,
        "ticks": g_ticks, "ms_per_tick": g_tick_ms,
        "step_wall_s": sum(step_s), "launches": g_launches,
        **{k: v for k, v in dataclasses.asdict(g_rep).items()
           if k not in ("outputs", "finish_order")},
        "profiled_drive_wall_s": prof_rep[1],
        "profiled_makespan_s": prof_rep[0].makespan_s,
        "device_busy_s": g_busy,
        "device_busy_share": (None if g_busy is None
                              else g_busy / prof_rep[1]),
        "device_top_kernels": g_top, **g_extra,
        "card_vs_cpu": serve_gaps, "moe_router": router_rows}}))
    print(json.dumps({"arena": {
        "config": "benchmarks/arena.py::main's phi0.4/clean cell with "
                  "run_mech's settings: " + json.dumps(ARENA_CFG)
                  + ", mechanisms " + json.dumps(ARENA_MECHS), **arena}}))
    print(json.dumps({"convergence": bound}))
    print(json.dumps({"sigkill_resume": sigkill}))
    print(json.dumps({"lm_snapshot": lm_snap}))
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
    if sys.argv[1:2] == ["--sim-child"]:       # phase 24's killed run
        sys.exit(sim_child(sys.argv[2]))
    sys.exit(main())

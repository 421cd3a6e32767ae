"""Traffic plane: deterministic arrival processes driving the serving engine
(the port of ``repro.serving.traffic``: the same numpy rng stream, so the
same requests bit for bit).

A :class:`TrafficConfig` describes a workload — an arrival process
(homogeneous Poisson, bursty on/off Poisson, or a replayed trace) plus
per-request prompt-length and generation-length distributions —
and ``generate_requests`` expands it into a concrete, fully seeded request
list.  ``drive`` then plays that list against a :class:`ServeEngine`,
submitting each request when the clock passes its arrival time and ticking
the engine while it has work.

Two clocks, one code path:

* **virtual** (``virtual_step_s`` set): every engine tick advances time by a
  fixed amount and idle gaps jump straight to the next arrival.  Fully
  deterministic — the determinism tests pin that the same seed yields the
  same arrival trace AND the same per-request token streams at any slot
  count.
* **wall** (``virtual_step_s=None``): real ``time.monotonic`` timestamps;
  idle gaps sleep until the next arrival.  This is what
  ``chip_smoke.py`` measures on the card.

The report aggregates tokens/sec, p50/p99 time-to-first-token, p50/p99
per-token decode latency, and mean/peak slot occupancy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.engine import GenerationConfig, ServeEngine


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """One serving workload.  All randomness flows from ``seed``."""
    process: str = "poisson"            # poisson | bursty | trace
    n_requests: int = 32
    rate: float = 4.0                   # poisson: arrivals/sec
    # bursty: on/off Poisson — base_rate normally, burst_rate inside bursts
    base_rate: float = 1.0
    burst_rate: float = 16.0
    burst_period_s: float = 4.0         # one on/off cycle
    burst_frac: float = 0.25            # leading fraction of the cycle is ON
    trace: Optional[Tuple[float, ...]] = None   # trace: arrival times (sec)
    prompt_len: Tuple[int, int] = (4, 24)       # uniform inclusive bounds
    gen_len: Tuple[int, int] = (8, 32)
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if self.process not in ("poisson", "bursty", "trace"):
            raise ValueError(f"unknown arrival process {self.process!r}")
        if self.process == "trace" and not self.trace:
            raise ValueError("process='trace' needs a non-empty trace")
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        for name in ("prompt_len", "gen_len"):
            lo, hi = getattr(self, name)
            if not (1 <= lo <= hi):
                raise ValueError(f"{name} bounds must satisfy 1 <= lo <= hi, "
                                 f"got ({lo}, {hi})")


@dataclasses.dataclass(frozen=True)
class Request:
    arrival_s: float
    prompt: np.ndarray
    gen: GenerationConfig


def arrival_times(cfg: TrafficConfig, rng: np.random.Generator) -> np.ndarray:
    """(n_requests,) float64 arrival times in seconds, sorted ascending."""
    n = cfg.n_requests
    if cfg.process == "trace":
        t = np.asarray(cfg.trace, np.float64)
        # tile a short trace cyclically (repeats shifted by the trace span)
        reps = int(np.ceil(n / len(t)))
        span = float(t[-1]) + (float(t[-1]) / max(len(t) - 1, 1) or 1.0)
        t = np.concatenate([t + i * span for i in range(reps)])[:n]
        return t
    if cfg.process == "poisson":
        gaps = rng.exponential(1.0 / cfg.rate, size=n)
        return np.cumsum(gaps)
    # bursty: thin a fine-grained Poisson clock by the on/off rate profile —
    # draw gaps at burst_rate, then stretch every gap that falls in the OFF
    # window by the rate ratio (equivalent to an inhomogeneous process with
    # piecewise-constant rate, but exactly reproducible from the gap draws)
    t, out = 0.0, []
    ratio = cfg.burst_rate / cfg.base_rate
    for g in rng.exponential(1.0 / cfg.burst_rate, size=n):
        phase = (t % cfg.burst_period_s) / cfg.burst_period_s
        t += g if phase < cfg.burst_frac else g * ratio
        out.append(t)
    return np.asarray(out, np.float64)


def generate_requests(cfg: TrafficConfig, vocab_size: int) -> List[Request]:
    """Deterministic expansion: same (cfg, vocab_size) -> same requests,
    bit-for-bit — arrival times, prompt tokens, and generation lengths all
    come from one ``np.random.default_rng(cfg.seed)`` stream."""
    rng = np.random.default_rng(cfg.seed)
    arrivals = arrival_times(cfg, rng)
    reqs = []
    for a in arrivals:
        plen = int(rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1))
        glen = int(rng.integers(cfg.gen_len[0], cfg.gen_len[1] + 1))
        prompt = rng.integers(0, vocab_size, size=plen).astype(np.int32)
        gen = GenerationConfig(max_new_tokens=glen,
                               temperature=cfg.temperature,
                               top_k=cfg.top_k, top_p=cfg.top_p)
        reqs.append(Request(arrival_s=float(a), prompt=prompt, gen=gen))
    return reqs


@dataclasses.dataclass
class TrafficReport:
    n_requests: int
    n_finished: int
    makespan_s: float
    total_tokens: int
    tokens_per_sec: float
    ttft_s: Dict[str, float]            # p50 / p99 / mean
    tok_latency_s: Dict[str, float]     # per generated token, p50 / p99 / mean
    occupancy: Dict[str, float]         # mean / peak, fraction of slots busy
    finish_order: List[int]             # request ids in completion order
    outputs: Dict[int, List[int]]       # rid -> generated tokens

    def rows(self) -> List[Tuple[str, float]]:
        """(metric name, value) pairs for the benchmark table."""
        return [
            ("tokens_per_sec", self.tokens_per_sec),
            ("ttft_p50_ms", self.ttft_s["p50"] * 1e3),
            ("ttft_p99_ms", self.ttft_s["p99"] * 1e3),
            ("tok_latency_p50_ms", self.tok_latency_s["p50"] * 1e3),
            ("tok_latency_p99_ms", self.tok_latency_s["p99"] * 1e3),
            ("slot_occupancy_mean", self.occupancy["mean"]),
            ("slot_occupancy_peak", self.occupancy["peak"]),
        ]


def _pct(xs: Sequence[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean())}


def drive(engine: ServeEngine, requests: Sequence[Request],
          virtual_step_s: Optional[float] = None,
          max_ticks: int = 1_000_000) -> TrafficReport:
    """Play ``requests`` against ``engine`` and aggregate latency stats.

    With ``virtual_step_s`` the clock is simulated (deterministic); without
    it, timestamps are wall-clock and idle gaps really sleep.  Either way the
    engine sees identical submissions in identical arrival order, so the
    token streams only depend on (params, requests) — never on the clock.
    """
    wall = virtual_step_s is None
    t0 = time.monotonic() if wall else 0.0
    now = 0.0
    pending = list(requests)            # already sorted by arrival
    submit_s: Dict[int, float] = {}
    first_s: Dict[int, float] = {}
    finish_s: Dict[int, float] = {}
    finish_order: List[int] = []
    occ: List[float] = []
    ticks = 0
    while (pending or engine.has_work) and ticks < max_ticks:
        while pending and pending[0].arrival_s <= now:
            r = pending.pop(0)
            rid = engine.submit(r.prompt, r.gen)
            submit_s[rid] = now
        if not engine.has_work:
            nxt = pending[0].arrival_s
            if wall:
                time.sleep(max(0.0, nxt - now))
                now = time.monotonic() - t0
            else:
                now = nxt
            continue
        events = engine.step()
        ticks += 1
        occ.append(engine.n_active / engine.B)
        now = (time.monotonic() - t0) if wall else now + virtual_step_s
        for rid in events["first_token"]:
            first_s[rid] = now
        for rid in events["finished"]:
            finish_s[rid] = now
            finish_order.append(rid)

    outputs = dict(engine.finished)
    total = sum(len(v) for v in outputs.values())
    makespan = max(finish_s.values(), default=now) or 1e-9
    # requests submitted before drive() was called (pre-queued work) have no
    # arrival timestamp here; they count for throughput but not for TTFT
    ttfts = [first_s[r] - submit_s[r] for r in first_s if r in submit_s]
    lat = []
    for rid, st in engine.stats.items():
        if rid in first_s and rid in finish_s and st.n_generated > 1:
            lat.append((finish_s[rid] - first_s[rid]) / (st.n_generated - 1))
    return TrafficReport(
        n_requests=len(requests), n_finished=len(finish_order),
        makespan_s=makespan, total_tokens=total,
        tokens_per_sec=total / makespan,
        ttft_s=_pct(ttfts), tok_latency_s=_pct(lat),
        occupancy={"mean": float(np.mean(occ)) if occ else 0.0,
                   "peak": float(np.max(occ)) if occ else 0.0},
        finish_order=finish_order, outputs=outputs)


# Arrival presets (the JAX package's, which its benchmarks/serving.py
# measures; chip_smoke.py drives "steady" on the card).  The trace preset
# replays a fixed ramp: a quiet start, an arrival spike, then a drain — the
# shape slot-claiming admission has to absorb without head-of-line blocking.
_RAMP_TRACE = tuple(float(x) for x in
                    list(np.linspace(0.0, 2.0, 6)) +          # quiet
                    list(np.linspace(2.05, 2.6, 12)) +        # spike
                    list(np.linspace(3.5, 6.0, 6)))           # drain

ARRIVAL_PRESETS: Dict[str, TrafficConfig] = {
    "steady": TrafficConfig(process="poisson", rate=6.0, n_requests=24,
                            seed=11),
    "bursty": TrafficConfig(process="bursty", base_rate=1.5, burst_rate=24.0,
                            burst_period_s=3.0, burst_frac=0.3, n_requests=24,
                            seed=12),
    "ramp_trace": TrafficConfig(process="trace", trace=_RAMP_TRACE,
                                n_requests=24, seed=13),
}

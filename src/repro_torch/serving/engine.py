"""Slot-based continuous-batching serving engine over the decode step (the
port of ``repro.serving.engine``).

A fixed batch of decode slots shares one batched decode step per tick;
every slot carries its own position clock, KV/state cache rows, sampling
generator and ``GenerationConfig``.  Each tick consumes one token per
slot: slots still inside their prompt consume the next PROMPT token
(incremental slot-claiming prefill), slots past it consume their previously
sampled token (decode) — so a request admitted mid-flight prefills inside
the same batched steps that keep every other slot decoding.  Finished
requests free their slot and queued requests claim it FIFO, immediately.

Per-slot isolation: the JAX package vmaps a one-row step; here the step is
batched with a (B,) position vector (``transformer.decode_step``), so each
row has its own rope positions, ring slot and ``k_pos`` mask, and MoE
layers route each row as a capacity group of its own.  A row's logits
depend only on its own tokens, so a request's stream does not depend on
what else is in flight or on the slot count.

Sampling: greedy / temperature / top-k / nucleus (``sample_token``), drawn
on the host from one ``torch.Generator`` per request, seeded from (engine
seed, request id).  The JAX package's threefry draws are not reproduced:
greedy streams are what the two packages share.

Everything runs on ``device`` ("cuda" unless the caller asks for "cpu");
the params must already be there.  Decoder-only families (dense, moe, ssm,
hybrid, and vlm decoding text only); an enc-dec config is refused with
``ValueError``, as the JAX package's engine refuses it (``launch/serve.py``
serves that family).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import registry as R
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0            # 0 = greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1 (or None), got {self.top_k}")
        if self.top_p is not None and not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1] (or None), got "
                             f"{self.top_p}")


@dataclasses.dataclass
class RequestStats:
    """Per-request lifecycle in engine TICKS (one tick = one batched decode
    step).  ``traffic.drive`` maps ticks to wall or virtual seconds."""
    rid: int
    prompt_len: int
    max_new_tokens: int
    submit_step: int
    admit_step: int = -1
    first_token_step: int = -1
    finish_step: int = -1
    n_generated: int = 0


@dataclasses.dataclass
class _Slot:
    request_id: Optional[int] = None
    gen: GenerationConfig = dataclasses.field(default_factory=GenerationConfig)
    prompt: Optional[np.ndarray] = None
    n_fed: int = 0                      # prompt tokens consumed so far
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    remaining: int = 0
    last_token: int = 0
    rng: Optional[torch.Generator] = None   # per-request sampling stream


def request_generator(seed: int, rid: int) -> torch.Generator:
    """The host generator of request ``rid``: seeded from (seed, rid) alone,
    so a request's draws do not depend on its slot or its neighbours."""
    state = np.random.SeedSequence([seed, rid]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & (2 ** 63 - 1))


def sample_token(logits: torch.Tensor, gen: Optional[torch.Generator],
                 cfg: GenerationConfig) -> torch.Tensor:
    """logits (B, V) f32 -> (B,) int64.

    ``temperature == 0`` is greedy (the lowest index wins a tie).
    Otherwise the logits are divided by the temperature, filtered by top-k
    (``top_k >= V`` keeps everything) and then by nucleus mass over the
    survivors (``top_p = 1`` keeps everything), and one token is drawn per
    row by the Gumbel-max rule with uniforms from ``gen`` on the logits'
    device.  A filter that keeps everything leaves the logits bit-identical,
    so its draws are those of plain temperature sampling."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / cfg.temperature
    v = logits.shape[-1]
    if cfg.top_k is not None:
        k = min(int(cfg.top_k), v)
        kth = torch.sort(logits, dim=-1).values[:, v - k][:, None]
        logits = torch.where(logits < kth, -1e30, logits)
    if cfg.top_p is not None:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        # smallest prefix with mass >= top_p; the clamp keeps every token
        # when rounding leaves the cumulative mass short of 1.0
        cut = torch.clamp((cum < cfg.top_p).sum(dim=-1), max=v - 1)
        cutoff = torch.gather(sorted_l, 1, cut[:, None])
        logits = torch.where(logits < cutoff, -1e30, logits)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def check_params_device(params: Params, dev: torch.device, what: str) -> None:
    """Raise unless every leaf of ``params`` lies on ``dev`` (params are
    never moved silently)."""
    for leaf in tree_leaves(params):
        if leaf.device.type != dev.type or (
                dev.index is not None and leaf.device != dev):
            raise ValueError(
                f"{what}: params lie on {leaf.device}, the engine runs on "
                f"{dev}; move them there first (tree_map(lambda t: "
                f"t.to(device), params))")


class ServeEngine:
    """See module docstring."""

    def __init__(self, cfg: ModelConfig, params: Params, batch_slots: int = 4,
                 max_len: int = 512, seed: int = 0, device="cuda"):
        if R.is_encdec(cfg):
            raise ValueError("ServeEngine handles decoder-only archs")
        self.device = resolve_device(device, "ServeEngine")
        check_params_device(params, self.device, "ServeEngine")
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.seed = seed
        self.cache = R.init_decode_cache(
            cfg, ShapeSpec("serve", max_len, batch_slots, "decode"),
            self.device)
        # a position clock per row: the batched step then gives each row
        # its own rope, ring slot, mask and MoE capacity group
        self.cache["pos"] = torch.zeros((batch_slots,), dtype=torch.int32,
                                        device=self.device)
        # one fresh single-row cache, copied into a slot at admission:
        # attention rows mask themselves (k_pos > pos excludes stale
        # entries) but recurrent state (the ssm state, the rglru h, their
        # conv tails) must be zeroed per request
        self._fresh_row = R.init_decode_cache(
            cfg, ShapeSpec("serve", max_len, 1, "decode"), self.device)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: List[Tuple[int, np.ndarray, GenerationConfig]] = []
        self.finished: Dict[int, List[int]] = {}
        self.stats: Dict[int, RequestStats] = {}
        self.t = 0                       # global tick counter
        self._next_id = 0
        self.last_logits: Optional[torch.Tensor] = None   # (B, V) f32

    # ------------------------------------------------------------------ API

    def submit(self, prompt: np.ndarray, gen: GenerationConfig) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or len(prompt) == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if len(prompt) + gen.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({gen.max_new_tokens}) exceeds max_len ({self.max_len})")
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, prompt, gen))
        self.stats[rid] = RequestStats(rid=rid, prompt_len=len(prompt),
                                       max_new_tokens=gen.max_new_tokens,
                                       submit_step=self.t)
        return rid

    @property
    def n_active(self) -> int:
        return sum(s.request_id is not None for s in self.slots)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    @torch.no_grad()
    def step(self) -> Dict[str, List[int]]:
        """One engine tick: admit, run one batched token step, sample.

        Returns the tick's lifecycle events (request ids): ``admitted``,
        ``first_token`` and ``finished`` (output now in ``self.finished``).
        A tick with no occupied slot is a no-op and does not advance the
        clock."""
        events: Dict[str, List[int]] = {"admitted": [], "first_token": [],
                                        "finished": []}
        self._admit(events["admitted"])
        active = [i for i, s in enumerate(self.slots)
                  if s.request_id is not None]
        if not active:
            return events
        toks = np.zeros((self.B, 1), np.int64)
        for i in active:
            s = self.slots[i]
            toks[i, 0] = (s.prompt[s.n_fed] if s.n_fed < len(s.prompt)
                          else s.last_token)
        logits, self.cache = R.serve_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(toks).to(self.device))
        logits = logits[:, -1, :self.cfg.vocab_size]
        self.last_logits = logits
        greedy = None                    # one host copy per tick, if needed
        for i in active:
            s = self.slots[i]
            if s.n_fed < len(s.prompt):
                # prompt token consumed; logits discarded (generation starts
                # by re-feeding the last prompt token, as the direct
                # prefill + step reference path does)
                s.n_fed += 1
                continue
            if s.gen.temperature <= 0.0:
                if greedy is None:
                    greedy = torch.argmax(logits, dim=-1).cpu().numpy()
                tok = int(greedy[i])
            else:
                tok = int(sample_token(logits[i:i + 1].cpu(), s.rng,
                                       s.gen)[0])
            first = not s.tokens_out
            s.tokens_out.append(tok)
            s.last_token = tok
            s.remaining -= 1
            st = self.stats[s.request_id]
            st.n_generated += 1
            if first:
                st.first_token_step = self.t
                events["first_token"].append(s.request_id)
            if s.remaining <= 0 or (s.gen.eos_id is not None
                                    and tok == s.gen.eos_id):
                st.finish_step = self.t
                self.finished[s.request_id] = s.tokens_out
                events["finished"].append(s.request_id)
                self.slots[i] = _Slot()
        self.t += 1
        return events

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drive until every submitted request finishes."""
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # ------------------------------------------------------------- internals

    def _admit(self, admitted: List[int]) -> None:
        """FIFO queue -> free slots, immediately.  The claimed slot's cache
        row and position clock reset; its prompt starts feeding on this very
        tick, interleaved with the other slots' decode."""
        for i, s in enumerate(self.slots):
            if s.request_id is not None or not self.queue:
                continue
            rid, prompt, gen = self.queue.pop(0)
            self._reset_row(i)
            self.slots[i] = _Slot(
                request_id=rid, gen=gen, prompt=prompt,
                remaining=gen.max_new_tokens, last_token=int(prompt[-1]),
                rng=request_generator(self.seed, rid))
            self.stats[rid].admit_step = self.t
            admitted.append(rid)

    def _reset_row(self, i: int) -> None:
        """Write the fresh row into slot i (the batch axis is leading for
        ``prelude``/``coda`` layer caches and second for ``blocks``)."""
        fresh, cache = self._fresh_row, self.cache
        for name in ("prelude", "coda"):
            tree_map(lambda full, row: full[i].copy_(row[0]), cache[name],
                     fresh[name])
        tree_map(lambda full, row: full[:, i].copy_(row[:, 0]),
                 cache["blocks"], fresh["blocks"])
        cache["pos"][i] = 0

"""End-to-end LM trainer: one model's local plane (the port of
``repro.launch.train``).

Trains any registry architecture on the synthetic token stream with the
train step of ``launch/steps.py``, on one device: the card unless
``--device cpu`` is given (the JAX package's trainer builds a host mesh and
sharding rules; here one device is explicit).  ``--smoke`` takes the
architecture's smoke geometry; ``--ckpt`` writes the final params and
optimizer state (``checkpoint.io``, the JAX package's layout).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --smoke --device cpu --steps 100 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import lm_batches, make_token_stream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.models import registry as R
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainRun:
    """What ``fit`` leaves: the final params and optimizer state (on the
    device), each step's loss, and each step's host wall (synchronised by
    reading the loss)."""
    cfg: ModelConfig
    params: Any
    opt_state: Any
    losses: List[float]
    step_wall_s: List[float]


def make_feed(cfg: ModelConfig, batch: int, seq: int, device
              ) -> Callable[[Dict[str, np.ndarray]], Dict[str, Any]]:
    """Host batches -> device batches, with the family's stub input as the
    JAX package's trainer makes it: zero frames for an enc-dec arch
    (``frames_for(cfg, seq)`` of them), and for a vlm the same random
    prefix embeddings every step, drawn from a generator seeded 1 on the
    device, in the config's dtype."""
    dtype = getattr(torch, cfg.dtype)
    stub = {}
    if R.is_encdec(cfg):
        stub["frames"] = torch.zeros(
            (batch, R.frames_for(cfg, seq), cfg.d_model), dtype=dtype,
            device=device)
    if R.has_prefix(cfg):
        stub["prefix_embeds"] = torch.randn(
            (batch, cfg.n_prefix_tokens, cfg.d_model),
            generator=torch.Generator(device).manual_seed(1),
            device=device).to(dtype)

    def feed(b: Dict[str, np.ndarray]) -> Dict[str, Any]:
        return {**{k: torch.from_numpy(v).to(device) for k, v in b.items()},
                **stub}

    return feed


def fit(cfg: ModelConfig, steps: int, batch: int, seq: int, lr: float,
        optimizer: str, device, log_every: int = 10,
        params: Optional[Any] = None,
        batches: Optional[Iterator[Dict[str, np.ndarray]]] = None
        ) -> TrainRun:
    """``steps`` train steps of ``cfg`` on ``device``, from ``params``
    (moved there) or else the init drawn from a generator seeded 0 on the
    device, over ``batches`` or else the trainer's token stream
    (``lm_batches`` over ``make_token_stream``, the JAX package's draws)."""
    opt = get_optimizer(optimizer, lr)
    if params is None:
        params = R.init_params(cfg, torch.Generator(device).manual_seed(0))
    else:
        params = tree_map(lambda leaf: leaf.to(device), params)
    opt_state = opt.init(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.arch_id} params={n_params / 1e6:.1f}M "
          f"optimizer={optimizer} lr={lr} device={device}")
    if batches is None:
        stream = make_token_stream(cfg.vocab_size,
                                   max(200_000, batch * seq * 4))
        batches = lm_batches(stream, batch, seq)
    feed = make_feed(cfg, batch, seq, device)
    step_fn = S.make_train_step(cfg, opt, remat=False)
    losses: List[float] = []
    walls: List[float] = []
    t0 = time.time()
    for i in range(1, steps + 1):
        t_step = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             feed(next(batches)))
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t_step)
        if i % log_every == 0 or i == steps:
            dt = (time.time() - t0) / i
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"(avg last10 {np.mean(losses[-10:]):.4f}) {dt:.2f}s/step")
    return TrainRun(cfg, params, opt_state, losses, walls)


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          lr: float = 3e-4, optimizer: str = "adam",
          ckpt_path: Optional[str] = None, log_every: int = 10,
          device="cuda", return_run: bool = False):
    """Train ``arch`` (its smoke geometry with ``smoke``) for ``steps``
    steps on ``device`` ("cuda" unless the caller asks for "cpu"; the card
    raises if there is none) and return the losses — or, with
    ``return_run``, the whole ``TrainRun``.  ``ckpt_path`` receives the
    final params and optimizer state."""
    cfg = R.get_smoke_config(arch) if smoke else R.get_config(arch)
    dev = resolve_device(device, "train")
    run = fit(cfg, steps, batch, seq, lr, optimizer, dev, log_every)
    if ckpt_path:
        save_checkpoint(ckpt_path, run.params, run.opt_state,
                        extra={"arch": cfg.arch_id, "steps": steps,
                               "final_loss": run.losses[-1]})
        print(f"checkpoint -> {ckpt_path}")
    return run if return_run else run.losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=R.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args()
    losses = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                   args.lr, args.optimizer, args.ckpt, device=args.device)
    print(f"loss: first10 {np.mean(losses[:10]):.4f} -> "
          f"last10 {np.mean(losses[-10:]):.4f}")


if __name__ == "__main__":
    main()

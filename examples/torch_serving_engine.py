"""Batched serving with the slot engine on the PyTorch port (the twin of
``examples/serving_engine.py``): submit a burst of requests with mixed
prompt lengths and sampling settings, watch slots recycle.  Runs on the
card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_serving_engine.py --arch smollm-135m
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import registry as R
from repro_torch.serving import GenerationConfig, ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=R.ARCH_IDS)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    dev = resolve_device(args.device, "torch_serving_engine")

    cfg = R.get_smoke_config(args.arch)
    params = R.init_params(cfg, torch.Generator(dev).manual_seed(0))
    eng = ServeEngine(cfg, params, batch_slots=args.slots, max_len=128,
                      device=dev)

    rng = np.random.default_rng(0)
    gens = [GenerationConfig(max_new_tokens=12),
            GenerationConfig(max_new_tokens=8, temperature=0.8, top_k=50),
            GenerationConfig(max_new_tokens=8, temperature=0.9, top_p=0.95)]
    rids = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(1, cfg.vocab_size, size=plen)
        rids.append(eng.submit(prompt, gens[i % len(gens)]))

    t0 = time.time()
    out = eng.run()
    dt = time.time() - t0
    total_toks = sum(len(v) for v in out.values())
    print(f"{args.requests} requests on {args.slots} slots -> "
          f"{total_toks} tokens in {dt:.1f}s ({total_toks / dt:.1f} tok/s, "
          f"{cfg.arch_id})")
    for rid in rids[:4]:
        print(f"  req {rid}: {out[rid]}")


if __name__ == "__main__":
    main()

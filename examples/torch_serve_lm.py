"""End-to-end LM path on the PyTorch port (the twin of
``examples/serve_lm.py``): briefly train a smoke-geometry architecture on
the synthetic token stream, checkpoint it, reload, and serve greedy decodes
with the production decode step (ring-buffer KV caches for local-attention
layers).  Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma2-2b
"""
import argparse
import tempfile

import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.synthetic import lm_batches, make_token_stream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.optim import get_optimizer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=R.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    dev = resolve_device(args.device, "torch_serve_lm")

    cfg = R.get_smoke_config(args.arch)
    if R.is_encdec(cfg) or R.has_prefix(cfg):
        raise SystemExit("pick a decoder-only arch for this example")

    opt = get_optimizer("adam", 1e-3)
    params = R.init_params(cfg, torch.Generator(dev).manual_seed(0))
    opt_state = opt.init(params)
    step_fn = S.make_train_step(cfg, opt, remat=False)
    batches = lm_batches(make_token_stream(cfg.vocab_size, 100_000), 8, 64)

    def to_dev(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    for i in range(1, args.steps + 1):
        params, opt_state, m = step_fn(params, opt_state, to_dev(next(batches)))
        if i % 10 == 0:
            print(f"train step {i}: loss {float(m['loss']):.4f}")

    with tempfile.NamedTemporaryFile(suffix=".npz") as f:
        save_checkpoint(f.name, params)
        params, _, _ = load_checkpoint(f.name, params)
        print("checkpoint round-trip OK")

    # serve
    shape = ShapeSpec("serve", 128, 2, "decode")
    cache = R.init_decode_cache(cfg, shape, dev)
    prompt = to_dev(next(batches))["tokens"][:2, :16]
    with torch.no_grad():
        _, cache = T.prefill_cache(cfg, params, cache, prompt)
        tok, out = prompt[:, -1:], []
        for _ in range(24):
            logits, cache = R.serve_step(cfg, params, cache, tok)
            tok = torch.argmax(logits[:, -1:, :cfg.vocab_size],
                               -1).to(torch.int32)
            out.append(int(tok[0, 0]))
    print(f"greedy continuation: {out}")


if __name__ == "__main__":
    main()

"""Batched decode from the command line: prefill a prompt batch, then
greedy-decode (the port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b \
        --smoke --device cpu --batch 4 --prompt-len 16 --gen 16

With ``--from-ckpt`` the params come from a fleet checkpoint written by the
JAX package's ``run_lm_federation`` instead of a fresh init — the Eq. 11
weighted global model by default, or one worker's own model with
``--worker i``.  The batch shares one position clock and, in MoE layers,
one capacity group, as in the JAX package (``ServeEngine`` gives each row
its own).  An encoder-decoder arch (seamless-m4t-medium) encodes stub
audio frames drawn from a ``torch.Generator`` on the device (the JAX
package draws them with ``jax.random``), fills the cross caches
(``encdec.fill_cross_cache``) and decodes the prompt step by step
(``E_prefill``).  The default device is the card.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.data.synthetic import make_token_stream
from repro_torch.device import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import registry as R
from repro_torch.models import transformer as T


@torch.no_grad()
def serve(arch: str, smoke: bool, batch: int, prompt_len: int, gen: int,
          max_len: int = 512, from_ckpt: str | None = None,
          worker: int | None = None, device="cuda") -> torch.Tensor:
    """Greedy sequences (batch, gen + 1): the last prompt token, then
    ``gen`` generated tokens."""
    cfg = R.get_smoke_config(arch) if smoke else R.get_config(arch)
    dev = resolve_device(device, "serve")
    if from_ckpt is not None:
        from repro_torch.serving.bridge import serving_params_from_checkpoint
        params = serving_params_from_checkpoint(from_ckpt, cfg, worker=worker,
                                                device=dev)
        src = f"ckpt={from_ckpt}" + ("" if worker is None
                                     else f" worker={worker}")
        print(f"loaded serving params from {src}")
    else:
        params = R.init_params(cfg, torch.Generator(dev).manual_seed(0))
    cache = R.init_decode_cache(cfg, ShapeSpec("serve", max_len, batch,
                                               "decode"), dev)

    stream = make_token_stream(cfg.vocab_size, batch * prompt_len + 1)
    prompt = torch.from_numpy(
        stream[:batch * prompt_len].reshape(batch, prompt_len)).to(dev)
    if R.is_encdec(cfg):
        frames = torch.randn(
            (batch, R.frames_for(cfg, max_len), cfg.d_model),
            generator=torch.Generator(dev).manual_seed(0), device=dev,
            dtype=torch.float32).to(getattr(torch, cfg.dtype))
        cache = E.fill_cross_cache(cfg, params, cache, frames)
        _, cache = E_prefill(cfg, params, cache, prompt)
    else:
        _, cache = T.prefill_cache(cfg, params, cache, prompt)

    tok = prompt[:, -1:]
    out = [tok]
    t0 = time.time()
    for _ in range(gen):
        logits, cache = R.serve_step(cfg, params, cache, tok)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1).to(
            prompt.dtype)
        out.append(tok)
    seqs = torch.cat(out, dim=1).cpu()
    dt = (time.time() - t0) / gen
    print(f"arch={cfg.arch_id} batch={batch} device={dev} "
          f"{dt * 1e3:.1f} ms/token")
    for b in range(min(batch, 2)):
        print(f"  sample[{b}]: {seqs[b][:16].tolist()} ...")
    return seqs


def E_prefill(cfg, params, cache, prompt):
    """Decode the prompt tokens (B, S0) into an enc-dec cache one step at a
    time (its cross caches filled) -> (logits (B, S0, V_pad), cache)."""
    logits = []
    for i in range(prompt.shape[1]):
        step, cache = E.decode_step(cfg, params, cache, prompt[:, i:i + 1])
        logits.append(step[:, 0])
    return torch.stack(logits, dim=1), cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=R.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--from-ckpt", default=None,
                    help="fleet checkpoint (.npz) to serve from; default is "
                         "the Eq. 11 weighted global model")
    ap.add_argument("--worker", type=int, default=None,
                    help="serve worker i's own model instead of the global")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args()
    serve(args.arch, args.smoke, args.batch, args.prompt_len, args.gen,
          from_ckpt=args.from_ckpt, worker=args.worker, device=args.device)


if __name__ == "__main__":
    main()

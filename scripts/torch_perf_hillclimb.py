"""The dry-run's perf ladders on the PyTorch port (the twin of
``scripts/perf_hillclimb.py``).

Runs the three chosen (arch x shape) pairs through their iteration ladders
with ``repro_torch.launch.dryrun.run_one``, each step counted once on the
``meta`` device (no card, nothing allocated) and tagged, so the records of
every rung land side by side under ``experiments/dryrun_torch/``.

    PYTHONPATH=src python scripts/torch_perf_hillclimb.py [h1|h2|h3 ...]

What the port's count can see: a dense-family train or prefill step (h1)
is counted as one rank's own sharded run on ``meta``, so a rung that
changes the sharding rules (``rule_overrides``: h1's ``q_seq``) moves its
FLOPs, bytes and collective bytes, and ``t_coll`` is a number.  Every
other step (h2's moe, h3's paper-mode round) is one unsharded step split
evenly at the H100's peaks: a rung that only changes the rules or the
paper-mode rules context (``paper_ctx``) moves no FLOP and no byte of it
(only the resident bytes a device holds), and there is no collective term
(``t_coll`` prints ``n/a``).  A rung with ``attn_impl="chunked"`` moves
nothing on a model without a prefix: its self-attention runs the flash
kernel whatever ``attn_impl`` says.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.dryrun import run_one  # noqa: E402


def emit(tag, rec):
    t_coll = rec["t_collective"]
    print(f"== {tag}: t_comp={rec['t_compute'] * 1e3:.1f}ms "
          f"t_mem={rec['t_memory'] * 1e3:.1f}ms t_coll="
          f"{'n/a' if t_coll is None else f'{t_coll * 1e3:.1f}ms'} "
          f"bottleneck={rec['bottleneck']} "
          f"useful={rec['useful_flops_ratio']:.3f}", flush=True)


def h1(**kw):
    """Memory-bound pick (worst useful-flops dense arch): smollm-135m
    train_4k.  Iter 1: chunked (online-softmax) attention.  Iter 2: +
    context-parallel q_seq (15 heads don't shard over model=16)."""
    emit("h1_iter0_baseline",
         run_one("smollm-135m", "train_4k", "single", tag="h1_iter0", **kw))
    emit("h1_iter1_chunked",
         run_one("smollm-135m", "train_4k", "single", attn_impl="chunked",
                 tag="h1_chunked", **kw))
    emit("h1_iter2_chunked_cp",
         run_one("smollm-135m", "train_4k", "single", attn_impl="chunked",
                 rule_overrides={"q_seq": ("model",)}, tag="h1_chunked_cp",
                 **kw))


def h2(**kw):
    """Collective-bound pick on the reference's production mesh:
    kimi-k2-1t train_4k.  Iter 1: co-shard the MoE contraction dim with the
    expert weights' fsdp axis.  Iter 2: + chunked attention."""
    emit("h2_iter0_baseline",
         run_one("kimi-k2-1t-a32b", "train_4k", "single", tag="h2_iter0",
                 **kw))
    emit("h2_iter1_psum_moe",
         run_one("kimi-k2-1t-a32b", "train_4k", "single",
                 rule_overrides={"moe_contract": ("data",)}, tag="h2_psum",
                 **kw))
    emit("h2_iter2_psum_chunked",
         run_one("kimi-k2-1t-a32b", "train_4k", "single",
                 attn_impl="chunked",
                 rule_overrides={"moe_contract": ("data",)},
                 tag="h2_psum_chunked", **kw))


def h3(**kw):
    """Paper-representative pick: the full DySTop round (train +
    pod-level staleness-weighted aggregation) for gemma2-2b train_4k on
    the 512-device multi-pod mesh.  Iter 1: the interior sharding rules
    on.  Iter 2: the pod aggregation over 4 local steps.  Iter 3: +
    chunked attention."""
    emit("h3_iter0_noctx",
         run_one("gemma2-2b", "train_4k", "multi", paper_mode=True,
                 paper_ctx=False, tag="h3_iter0", **kw))
    emit("h3_iter1_ctx",
         run_one("gemma2-2b", "train_4k", "multi", paper_mode=True,
                 tag="h3_iter1", **kw))
    emit("h3_iter2_local4",
         run_one("gemma2-2b", "train_4k", "multi", paper_mode=True,
                 local_steps=4, tag="h3_iter2", **kw))
    emit("h3_iter3_local4_chunked",
         run_one("gemma2-2b", "train_4k", "multi", paper_mode=True,
                 local_steps=4, attn_impl="chunked", tag="h3_iter3", **kw))


LADDERS = {"h1": h1, "h2": h2, "h3": h3}

if __name__ == "__main__":
    for name in sys.argv[1:] or list(LADDERS):
        print(f"---- hillclimb {name} ----", flush=True)
        LADDERS[name]()

"""Follow-up dry-run iterations on the PyTorch port (the twin of
``scripts/perf_hillclimb2.py``; see ``scripts/torch_perf_hillclimb.py``
for what the port's count can see).

H1 iter 3/4: context parallelism alone, then chunked attention with
2048-wide kv blocks under it; H2 iter 3 (``h2_iter3``, not run by
default): the MoE capacity dim reduce-scattered over ``data``.

    PYTHONPATH=src python scripts/torch_perf_hillclimb2.py
"""
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.dryrun import run_one  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from torch_perf_hillclimb import emit  # noqa: E402


def h1_iter3(**kw):
    """Context parallel alone (naive attention): isolate its effect."""
    emit("h1_iter3_cp_only",
         run_one("smollm-135m", "train_4k", "single",
                 rule_overrides={"q_seq": ("model",)}, tag="h1_cp_only",
                 **kw))


def h1_iter4(**kw):
    """Context parallel + chunked with 2048-wide kv blocks, the chunk
    widened through a temporary ``get_config`` override."""
    orig = R.get_config
    R.get_config = lambda arch: dataclasses.replace(orig(arch),
                                                    attn_chunk=2048)
    try:
        emit("h1_iter4_cp_chunk2048",
             run_one("smollm-135m", "train_4k", "single",
                     attn_impl="chunked",
                     rule_overrides={"q_seq": ("model",)},
                     tag="h1_cp_chunk2048", **kw))
    finally:
        R.get_config = orig


def h2_iter3(**kw):
    emit("h2_iter3_rscatter",
         run_one("kimi-k2-1t-a32b", "train_4k", "single",
                 rule_overrides={"moe_contract": ("data",),
                                 "moe_h_cap": ("data",)},
                 tag="h2_rscatter", **kw))


if __name__ == "__main__":
    h1_iter3()
    h1_iter4()

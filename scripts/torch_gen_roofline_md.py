"""Markdown roofline tables from the PyTorch port's dry-run records
(``experiments/dryrun_torch/*.json``; the twin of
``scripts/gen_roofline_md.py``).

    PYTHONPATH=src python scripts/torch_gen_roofline_md.py [single|multi|host]

Tagged records (a ladder's rungs, paper mode's ``_dystop``) are skipped, as
the reference skips them.  The times are the counts of one unsharded step
at the H100's data-sheet peaks (``repro_torch.launch.analysis``); ``t_coll``
is ``n/a`` where no step runs sharded.
"""
import json
import pathlib
import sys

DRY = pathlib.Path(__file__).resolve().parents[1] / "experiments" \
    / "dryrun_torch"
MESHES = ("single", "multi", "host")

REMEDY = {
    ("memory", "train"): "fuse the eager elementwise chains (norms, "
                         "activations, Adam) into fewer passes; a flash "
                         "backward kernel in place of the plain attention "
                         "backward",
    ("memory", "prefill"): "fuse the elementwise chains around the flash "
                           "kernel; keep the (S, S) scores out of HBM on "
                           "the paths that run plain attention",
    ("memory", "serve"): "KV-cache layout: batch the single-token "
                         "products, a CUDA graph per decode step",
    ("memory", "dystop_round"): "fuse the elementwise chains inside each "
                                "pod's step; one fused Adam over the flat "
                                "row",
    ("collective", "train"): "co-shard the MoE contraction with the expert "
                             "fsdp axis; overlap NVLink collectives with "
                             "compute",
    ("collective", "prefill"): "same as train: contraction co-sharding + "
                               "overlap",
    ("collective", "serve"): "replicate small per-step tensors; batch "
                             "collectives across layers",
    ("collective", "dystop_round"): "amortize the pod aggregation over "
                                    "local steps",
    ("compute", "train"): "already compute-bound: bf16 wgmma tiles that "
                          "keep the tensor cores fed",
    ("compute", "prefill"): "already compute-bound: bf16 wgmma tiles that "
                            "keep the tensor cores fed",
}


def _ms(t) -> str:
    return "n/a" if t is None else f"{t * 1e3:.1f}ms"


def fmt(recs, mesh: str) -> str:
    rows = ["| arch | shape | mode | t_comp | t_mem | t_coll | bottleneck "
            "| MODEL_FLOPS | useful | what moves the dominant term |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("skipped") or r.get("mesh") != mesh:
            continue
        remedy = REMEDY.get((r["bottleneck"], r["mode"]), "—")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mode']} "
            f"| {_ms(r['t_compute'])} | {_ms(r['t_memory'])} "
            f"| {_ms(r['t_collective'])} | **{r['bottleneck']}** "
            f"| {r['model_flops']:.2e} | {r['useful_flops_ratio']:.2f} "
            f"| {remedy} |")
    return "\n".join(rows)


def load(dry: pathlib.Path = DRY) -> list:
    """The untagged records under ``dry``, in file-name order."""
    return [json.loads(f.read_text()) for f in sorted(dry.glob("*.json"))
            if f.stem.split("_")[-1] in MESHES]


def main() -> None:
    mesh = sys.argv[1] if len(sys.argv) > 1 else "single"
    print(fmt(load(), mesh))


if __name__ == "__main__":
    main()

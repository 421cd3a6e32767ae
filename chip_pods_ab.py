#!/usr/bin/env python3
"""Phase 41 of ``chip_smoke.py`` (the pods plane: 4 smollm-135m replicas,
stacked and on 4 gloo ranks sharing the card) alone, from the checkout
given as the argument, with its kernels built there; prints one JSON line:
the stacked and rank forms' round walls, the all-gather's host seconds a
round, the peaks and ``aggregate``'s times.

To hold two commits against each other on one card, unpack both into a
directory that ``.gitignore`` lists and run them in one call, in the order
parent, change, change, parent::

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/archive
    for t in parent archive archive parent; do
        python3 chip_pods_ab.py build/$t | tail -n 1; done
"""
import json
import os
import sys
import time


def main() -> None:
    tree = os.path.abspath(sys.argv[1])
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    os.chdir(tree)
    import chip_smoke as CS
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    t1 = time.perf_counter()
    out, agg, flash = CS.pods_phase()
    print(json.dumps({
        "tree": sys.argv[1], "build_s": t1 - t0,
        "phase_s": time.perf_counter() - t1,
        "stacked_round_walls_s": out["stacked"]["round_walls_s"],
        "stacked_peak": out["stacked"]["max_memory_allocated_bytes"],
        "rank_round_walls_s": out["ranks"]["round_walls_s"][0],
        "gather_s": out["ranks"]["gather_s"],
        "rank_peaks": out["ranks"]["max_memory_allocated_bytes"],
        "agg_ms": [r["ms"] for r in agg],
        "bits": [out["rows_bit_equal"], out["metrics_bit_equal"]]}),
        flush=True)


if __name__ == "__main__":        # the ranks re-import this file
    main()

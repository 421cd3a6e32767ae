"""Quickstart on the PyTorch port: a 20-worker DySTop federation (the twin
of ``examples/quickstart.py``).

Shows the full public API surface: synthetic non-IID data, the edge-network
model, WAA + PTCA coordination, kernel aggregation, and the metrics the
paper reports (accuracy vs simulated wall-clock, communication, staleness).
Runs on the card unless ``--device cpu`` is given (the kernels' plain
versions there).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

from repro_torch.core.protocol import DySTop
from repro_torch.dfl.simulator import SimConfig, run_simulation


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    # the reference asks for its Pallas backend here; the port has no
    # backend switch: the device decides (CUDA tensors launch the CUDA
    # kernels, CPU tensors run their plain versions)
    cfg = SimConfig(
        n_workers=20,
        n_rounds=80,
        phi=0.4,                 # strongly non-IID (Dirichlet)
        tau_bound=5,             # staleness constraint (paper Eq. 12c)
        V=10.0,                  # Lyapunov trade-off (paper Eq. 34)
        lr=0.1,
        eval_every=20,
        seed=0,
    )
    mech = DySTop(V=cfg.V, t_thre=25, max_neighbors=5)
    hist = run_simulation(mech, cfg, device=args.device)

    print(f"{'round':>6} {'sim-time(s)':>12} {'comm(GB)':>9} "
          f"{'acc(global)':>12} {'stale(avg/max)':>15}")
    for i, r in enumerate(hist.rounds):
        print(f"{r:6d} {hist.sim_time[i]:12.1f} {hist.comm_gb[i]:9.4f} "
              f"{hist.acc_global[i]:12.3f} "
              f"{hist.staleness_avg[i]:7.2f}/{hist.staleness_max[i]:<4d}")
    print(f"\nwall-clock: {hist.wall_s:.1f}s; staleness stayed bounded and "
          f"accuracy climbed under non-IID data — that's DySTop working.")


if __name__ == "__main__":
    main()

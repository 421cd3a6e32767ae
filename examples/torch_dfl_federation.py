"""The paper's headline comparison on the PyTorch port (the twin of
``examples/dfl_federation.py``): DySTop vs MATCHA vs AsyDFL vs SA-ADFL at
two non-IID levels, compared at EQUAL SIMULATED TIME (the paper's x-axis);
reports time-to-accuracy and communication-to-accuracy (paper Figs. 4-13).
Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_dfl_federation.py [--sim-time 1500]
"""
import argparse

from repro_torch.core.baselines import get_mechanism
from repro_torch.dfl.simulator import SimConfig, run_simulation


def first_time_to(hist, target):
    for i, a in enumerate(hist.acc_global):
        if a >= target:
            return hist.sim_time[i], hist.comm_gb[i]
    return None, None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sim-time", type=float, default=1500.0)
    ap.add_argument("--workers", type=int, default=30)
    ap.add_argument("--target", type=float, default=0.55)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    print(f"{'mechanism':>10} {'phi':>4} {'rounds':>6} {'final-acc':>9} "
          f"{'t@{:.0%}'.format(args.target):>10} {'GB@target':>9}")
    for phi in (1.0, 0.4):
        results = {}
        for name in ("dystop", "sa-adfl", "asydfl", "matcha"):
            cfg = SimConfig(n_workers=args.workers, n_rounds=4000, phi=phi,
                            lr=0.1, max_sim_time=args.sim_time, seed=0)
            kw = {"V": 10.0, "t_thre": 60} if name == "dystop" else {}
            hist = run_simulation(get_mechanism(name, **kw), cfg,
                                  device=args.device)
            t_tgt, gb_tgt = first_time_to(hist, args.target)
            results[name] = t_tgt
            print(f"{name:>10} {phi:4.1f} {hist.rounds[-1]:6d} "
                  f"{hist.acc_global[-1]:9.3f} "
                  f"{t_tgt if t_tgt is None else round(t_tgt, 1)!s:>10} "
                  f"{gb_tgt if gb_tgt is None else round(gb_tgt, 3)!s:>9}")
        d = results["dystop"]
        for other in ("asydfl", "matcha"):
            if d and results[other]:
                print(f"    -> DySTop reaches {args.target:.0%} "
                      f"{results[other] / d:.1f}x faster than {other} at "
                      f"phi={phi}")


if __name__ == "__main__":
    main()

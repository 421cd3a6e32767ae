"""DySTop federating REAL architectures on the PyTorch port (the twin of
``examples/dfl_lm.py``): N workers each training a smoke-geometry zoo
model (pick any decoder-only --arch), driven by the SAME HorizonPlanner +
chunked dispatch as the simulation plane — params and optimizer state live
in resident flat (N, P) / (N, S) buffers for the whole run.  Runs on the
card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_dfl_lm.py --arch gemma2-2b --rounds 25

``--oracle`` runs the per-call-flatten architecture (masked train-all-N
step) on the identical control plane, for eyeball A/Bs.
"""
import argparse

from repro_torch.core.protocol import DySTop
from repro_torch.dfl import lm_worker as LW
from repro_torch.models import registry as R


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=R.ARCH_IDS)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--optimizer", default="adam",
                    choices=("adam", "sgd", "adafactor"))
    ap.add_argument("--horizon", type=int, default=8,
                    help="rounds per planned chunk")
    ap.add_argument("--oracle", action="store_true",
                    help="per-call-flatten baseline (resident_fleet=False)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    cfg = R.get_smoke_config(args.arch)
    if R.is_encdec(cfg) or R.has_prefix(cfg):
        raise SystemExit("pick a decoder-only arch for this example")
    run = LW.LMRunConfig(
        n_workers=args.workers, n_rounds=args.rounds, batch=args.batch,
        seq=args.seq, optimizer=args.optimizer, scan_horizon=args.horizon,
        resident_fleet=not args.oracle, eval_every=5)
    mech = DySTop(V=3.0, t_thre=args.rounds // 3, max_neighbors=3)

    print(f"federating {args.workers} x {cfg.arch_id} "
          f"({'oracle' if args.oracle else 'resident'} engine, "
          f"horizon {args.horizon})")
    fleet, hist = LW.run_lm_federation(mech, cfg, run, device=args.device)
    print(f"{fleet.model_bytes / 1e6:.1f} MB params + "
          f"{fleet.opt_bytes / 1e6:.1f} MB {args.optimizer} state per replica")

    for i, t in enumerate(hist.rounds):
        print(f"round {t:3d}: sim-time {hist.sim_time[i]:7.1f}s "
              f"comm {hist.comm_gb[i] * 1e3:6.1f}MB "
              f"mean-local-loss {hist.loss_local[i]:.4f} "
              f"global-loss {hist.loss_global[i]:.4f} "
              f"tau_max={hist.staleness_max[i]}")
    per_round = (hist.wall_s - hist.eval_wall_s - hist.setup_wall_s) \
        / max(args.rounds, 1)
    print(f"engine: {per_round * 1e3:.1f} ms/round "
          f"(setup {hist.setup_wall_s:.1f}s, eval {hist.eval_wall_s:.1f}s)")


if __name__ == "__main__":
    main()

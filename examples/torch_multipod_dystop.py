"""Pods-as-workers on the PyTorch port: DySTop's pull-aggregate across whole
model replicas (``repro_torch.core.protocol.dystop_pod_mix``), the twin of
``examples/multipod_dystop.py``.

Four "pods", each holding one MLP replica (the leaves stacked on a leading
pod axis), start from different draws.  Each round the host coordinator
(WAA over simulated pod round costs) activates pods, every active pod pulls
from all its peers, and the Eq. 4 mixing matrix mixes the replicas: the
pods' leaves flattened into one (n_pods, P) f32 buffer and one ``aggregate``
kernel launch.  The replica spread shrinks as activated pods pull and
aggregate.  Runs on the card unless ``--device cpu`` is given (the kernel's
plain version there).

    PYTHONPATH=src python examples/torch_multipod_dystop.py
    PYTHONPATH=src python examples/torch_multipod_dystop.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core.aggregation import mixing_matrix
from repro_torch.core.protocol import dystop_pod_mix
from repro_torch.core.staleness import StalenessState
from repro_torch.core.waa import worker_activation
from repro_torch.device import resolve_device
from repro_torch.dfl import worker as WK
from repro_torch.tree import tree_map


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    dev = resolve_device(args.device, "torch_multipod_dystop")
    n_pods = 4

    # n_pods replicas, intentionally divergent: one draw per pod
    pods = [WK.init_mlp(torch.Generator().manual_seed(i), 16, 32, 4)
            for i in range(n_pods)]
    stacked = tree_map(lambda *leaves: torch.stack(leaves).to(dev), *pods)

    st = StalenessState.create(n_pods, tau_bound=2)
    rng = np.random.default_rng(0)
    for t in range(1, 6):
        # control plane (host): WAA over simulated pod round costs
        cost = rng.uniform(1.0, 3.0, n_pods)
        active, _ = worker_activation(st, cost, V=5.0)
        links = np.zeros((n_pods, n_pods), bool)
        for i in np.flatnonzero(active):      # each active pod pulls all peers
            links[i] = True
            links[i, i] = False
        W = mixing_matrix(active, links, np.ones(n_pods))

        # data plane: one flat (n_pods, P) buffer, one aggregate launch
        stacked = dystop_pod_mix(stacked, W)
        st.advance(active)

        spread = float(stacked["w1"].float().std(dim=0, correction=0).mean())
        print(f"round {t}: active={np.flatnonzero(active).tolist()} "
              f"tau={st.tau.tolist()} replica-spread={spread:.4f}")

    print("replica spread shrinks as activated pods pull+aggregate — "
          "DySTop over the pod axis works.")


if __name__ == "__main__":
    main()

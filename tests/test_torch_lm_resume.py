"""Snapshots and resume on the port's LM fleet and under the fleet mesh.

The LM fleet (smollm-135m smoke geometry, 3 workers): a run resumed from a
``checkpoint_every`` run's round-2 snapshot finishes on the uninterrupted
run exactly (control plane, losses, and both resident buffers: the f32
buffers hold the bf16 and int32 leaves exactly), and a snapshot of another
optimizer is refused (the LM snapshots' layout against the JAX package's:
tests/test_torch_bridge.py, both ways).  The mesh (S = 2 gloo ranks on
the CPU, 9 workers, so one padding row): rank 0 writes the snapshot without
the padding, and a resumed mesh run finishes on the uninterrupted mesh
run (rtol 1e-6, atol 1e-7).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import io as CIO
from repro_torch.core.protocol import DySTop
from repro_torch.dfl import lm_worker as LW
from repro_torch.dfl.simulator import SimConfig, run_simulation
from repro_torch.models import registry as R
from test_torch_resume import _one_torch_thread  # noqa: F401

CONTROL = ("rounds", "sim_time", "comm_gb", "staleness_avg", "staleness_max",
           "round_durations", "round_active")
KW = dict(n_workers=3, n_rounds=4, batch=2, seq=16, eval_every=2, seed=1,
          checkpoint_every=2)


def _mech():
    return DySTop(V=3.0, t_thre=3, max_neighbors=3)


def test_lm_resume_matches_uninterrupted(tmp_path):
    cfg = R.get_smoke_config("smollm-135m")
    run = LW.LMRunConfig(checkpoint_dir=str(tmp_path), **KW)
    full_f, full = LW.run_lm_federation(_mech(), cfg, run, device="cpu")
    snaps = CIO.list_checkpoints(tmp_path)
    assert [p.name for p in snaps] == ["ckpt_round000002.npz",
                                       "ckpt_round000004.npz"]
    res_f, res = LW.run_lm_federation(_mech(), cfg, run, str(snaps[0]),
                                      device="cpu")
    for f in CONTROL + ("loss_global", "loss_local", "round_loss"):
        assert getattr(res, f) == getattr(full, f), f
    assert torch.equal(res_f.pbuf, full_f.pbuf)
    assert torch.equal(res_f.obuf, full_f.obuf)
    # the last snapshot holds the final fleet, bit for bit
    blobs, extra = CIO.read_checkpoint(snaps[1])
    assert extra["config"]["arch"] == cfg.arch_id
    np.testing.assert_array_equal(blobs["params|pbuf"], full_f.pbuf.numpy())
    np.testing.assert_array_equal(blobs["params|obuf"], full_f.obuf.numpy())
    other = dataclasses.replace(run, optimizer="sgd")
    with pytest.raises(ValueError, match="resume config mismatch"):
        LW.run_lm_federation(_mech(), cfg, other, str(snaps[0]),
                             device="cpu")


def test_sim_mesh_resume(tmp_path):
    kw = dict(n_workers=9, n_rounds=20, hidden=16, n_samples=2000, phi=0.5,
              lr=0.1, eval_every=5, mesh_shards=2, checkpoint_every=10,
              checkpoint_dir=str(tmp_path))
    mech = lambda: DySTop(V=10.0, t_thre=8, max_neighbors=4)  # noqa: E731
    full = run_simulation(mech(), SimConfig(**kw), device="cpu")
    assert full.mesh_backend == "gloo"
    first = CIO.checkpoint_path(tmp_path, 10)
    blobs, extra = CIO.read_checkpoint(first)
    assert blobs["params|buf"].shape[0] == 9     # no padding row written
    assert extra["config"]["mesh_shards"] == 2
    res = run_simulation(mech(), SimConfig(**kw), device="cpu",
                         resume_from=str(first))
    for f in CONTROL:
        assert getattr(res, f) == getattr(full, f), f
    for f in ("acc_global", "acc_local", "loss_global"):
        np.testing.assert_allclose(getattr(res, f), getattr(full, f),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    # the same run without a mesh takes no mesh snapshot
    with pytest.raises(ValueError, match="mesh_shards"):
        run_simulation(mech(), SimConfig(**dict(kw, mesh_shards=1)),
                       device="cpu", resume_from=str(first))

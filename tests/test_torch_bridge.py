"""The port's traffic plane, checkpoint bridge and ``launch/serve.py``, held
against the JAX package's.

``generate_requests`` must give the reference's arrays bit for bit (one
numpy stream); ``drive`` under a virtual clock the same finish order,
occupancy and outputs as the reference's engine (f32 smollm-135m smoke,
from the reference's init).  The bridge reads a snapshot that the JAX
package's ``run_lm_federation`` writes (as ``tests/test_serving.py``'s
``trained_fleet`` makes one): a worker row bit for bit, the Eq. 11 global
model to f32 tolerance (1e-6: the same ``alpha @ pbuf`` summed in another
order), greedy streams as the reference's (bf16: equal but at a step where
the reference's top-2 gap is under 0.1, see ``tests/test_torch_serving.py``).
A snapshot the port's own ``run_lm_federation`` writes serves the same way.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import serve as T_SERVE
from repro_torch.models import registry as T_R
from repro_torch.serving import (ARRIVAL_PRESETS, GenerationConfig,
                                 ServeEngine, TrafficConfig, drive,
                                 engine_from_checkpoint,
                                 serving_params_from_checkpoint,
                                 generate_requests)
from repro_torch.dfl import flat_state as T_FS
from repro_torch.serving import bridge as T_BR
from repro_torch.tree import tree_paths
from test_torch_resume import _one_torch_thread  # noqa: F401
from test_torch_resume import one_torch_thread
from test_torch_serving import BF16_TOL, _reference, reference_logits

TRAFFIC = [TrafficConfig(process="poisson", rate=5.0, n_requests=16, seed=3),
           TrafficConfig(process="bursty", n_requests=20, prompt_len=(2, 9),
                         gen_len=(1, 5), temperature=0.7, top_k=5, seed=9)]


@pytest.mark.parametrize("tc", TRAFFIC + list(ARRIVAL_PRESETS.values()))
def test_generate_requests_match_reference(tc):
    pytest.importorskip("jax")
    from repro.serving import traffic as R_TR
    r_tc = R_TR.TrafficConfig(**dataclasses.asdict(tc))
    want = R_TR.generate_requests(r_tc, 512)
    got = generate_requests(tc, 512)
    assert [r.arrival_s for r in got] == [r.arrival_s for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == b.prompt.dtype
        assert dataclasses.asdict(a.gen) == dataclasses.asdict(b.gen)


def test_presets_match_reference():
    pytest.importorskip("jax")
    from repro.serving import traffic as R_TR
    assert {k: dataclasses.asdict(v) for k, v in ARRIVAL_PRESETS.items()} \
        == {k: dataclasses.asdict(v) for k, v in
            R_TR.ARRIVAL_PRESETS.items()}


def test_virtual_clock_drive_matches_reference():
    """Same arrivals through both engines on the virtual clock: identical
    finish order, occupancy, outputs and tick-derived latencies."""
    jax = pytest.importorskip("jax")
    from repro.serving import ServeEngine as R_Engine
    from repro.serving import traffic as R_TR
    r_cfg, params, t_cfg, t_params = _reference("smollm-135m", "float32")
    tc = TrafficConfig(process="poisson", rate=30.0, n_requests=7,
                       prompt_len=(3, 8), gen_len=(3, 6), seed=5)
    with jax.default_device(jax.devices("cpu")[0]):
        want = R_TR.drive(R_Engine(r_cfg, params, batch_slots=2, max_len=32),
                          R_TR.generate_requests(
                              R_TR.TrafficConfig(**dataclasses.asdict(tc)),
                              r_cfg.vocab_size), virtual_step_s=0.01)
    got = drive(ServeEngine(t_cfg, t_params, batch_slots=2, max_len=32,
                            device="cpu"),
                generate_requests(tc, t_cfg.vocab_size), virtual_step_s=0.01)
    assert got.finish_order == want.finish_order
    assert got.occupancy == want.occupancy
    assert got.outputs == want.outputs
    assert got.n_finished == want.n_finished == tc.n_requests
    assert got.ttft_s == want.ttft_s
    assert got.tok_latency_s == want.tok_latency_s
    assert got.rows() == want.rows()


def test_fifo_completion_under_overload():
    cfg = T_R.get_smoke_config("smollm-135m")
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=64, device="cpu")
    g = GenerationConfig(max_new_tokens=4)
    rids = [eng.submit(np.arange(1 + i, 7 + i, dtype=np.int32), g)
            for i in range(9)]
    rep = drive(eng, [], virtual_step_s=0.01)
    assert rep.finish_order == rids
    assert all(len(rep.outputs[r]) == 4 for r in rids)


# -- checkpoint -> serving bridge ----------------------------------------------


@pytest.fixture(scope="module")
def trained_fleet(tmp_path_factory):
    """A tiny LM fleet trained by the JAX package, and its latest snapshot."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint import io as CIO
    from repro.core.protocol import DySTop
    from repro.dfl import lm_worker as LW
    from repro.models import registry as R_R
    cfg = R_R.get_smoke_config("smollm-135m")
    ckdir = tmp_path_factory.mktemp("fleet_ck")
    run = LW.LMRunConfig(n_workers=4, n_rounds=6, batch=2, seq=16,
                         eval_every=3, seed=1, checkpoint_every=3,
                         checkpoint_dir=str(ckdir))
    with jax.default_device(jax.devices("cpu")[0]):
        fleet, _ = LW.run_lm_federation(
            DySTop(V=3.0, t_thre=3, max_neighbors=3), cfg, run)
    ck = CIO.latest_checkpoint(ckdir)
    assert ck is not None
    return cfg, fleet, ck


def _leaves(tree):
    import jax
    return [np.asarray(leaf) for leaf in jax.tree.leaves(tree)]


def test_bridge_worker_row_bitwise_and_global_close(trained_fleet):
    from repro.serving import bridge as R_BR
    r_cfg, fleet, ck = trained_fleet
    cfg = T_R.get_smoke_config("smollm-135m")
    for w in (0, fleet.pbuf.shape[0] - 1):
        got = serving_params_from_checkpoint(ck, cfg, worker=w, device="cpu")
        want = _leaves(R_BR.serving_params_from_checkpoint(ck, r_cfg,
                                                           worker=w))
        for (_, a), b in zip(tree_paths(got), want):
            assert str(a.dtype).replace("torch.", "") == str(b.dtype)
            np.testing.assert_array_equal(a.float().numpy(),
                                          b.astype(np.float32))
    got = serving_params_from_checkpoint(ck, cfg, device="cpu")
    want = _leaves(R_BR.serving_params_from_checkpoint(ck, r_cfg))
    for (_, a), b in zip(tree_paths(got), want):
        np.testing.assert_allclose(a.float().numpy(), b.astype(np.float32),
                                   atol=1e-6, rtol=0)
    spec, r_spec = T_BR.fleet_spec_for(cfg), R_BR.fleet_spec_for(r_cfg)
    assert (spec.offsets, spec.sizes, spec.shapes, spec.n_params) == (
        r_spec.offsets, r_spec.sizes, r_spec.shapes, r_spec.n_params)


def test_bridge_streams_match_reference_engine(trained_fleet):
    jax = pytest.importorskip("jax")
    from repro.serving import bridge as R_BR
    from test_torch_serving import near_tie_steps
    r_cfg, _, ck = trained_fleet
    cfg = T_R.get_smoke_config("smollm-135m")
    reqs = generate_requests(TrafficConfig(n_requests=4, prompt_len=(3, 9),
                                           gen_len=(4, 8), seed=2),
                             cfg.vocab_size)
    for worker in (None, 1):
        with jax.default_device(jax.devices("cpu")[0]):
            ref = R_BR.engine_from_checkpoint(ck, r_cfg, worker=worker,
                                              batch_slots=2, max_len=32)
            for r in reqs:
                ref.submit(r.prompt, r.gen)
            want = ref.run()
        eng = engine_from_checkpoint(ck, cfg, worker=worker, batch_slots=2,
                                     max_len=32, device="cpu")
        for r in reqs:
            eng.submit(r.prompt, r.gen)
        got = eng.run()
        params = R_BR.serving_params_from_checkpoint(ck, r_cfg, worker=worker)
        assert near_tie_steps(r_cfg, params, reqs, got, want) <= 1


def test_serve_from_checkpoint_matches_reference(trained_fleet):
    jax = pytest.importorskip("jax")
    from repro.launch import serve as R_SERVE
    from repro.serving import bridge as R_BR
    r_cfg, _, ck = trained_fleet
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(R_SERVE.serve("smollm-135m", True, 2, 6, 6,
                                        max_len=32, from_ckpt=str(ck)))
    got = T_SERVE.serve("smollm-135m", True, 2, 6, 6, max_len=32,
                        from_ckpt=str(ck), device="cpu").numpy()
    assert got.shape == want.shape == (2, 7)
    if not np.array_equal(got, want):
        # a batch stream may leave the reference only at a near tie
        params = R_BR.serving_params_from_checkpoint(ck, r_cfg)
        for b in range(2):
            diff = np.nonzero(got[b] != want[b])[0]
            if len(diff):
                from repro.data.synthetic import make_token_stream
                stream = make_token_stream(r_cfg.vocab_size, 2 * 6 + 1)
                prompt = stream[:12].reshape(2, 6)[b]
                lg = reference_logits(r_cfg, params, prompt, want[b, 1:])
                top2 = np.sort(lg[diff[0] - 1])[-2:]
                assert top2[1] - top2[0] < BF16_TOL


def test_bridge_rejects_wrong_geometry(trained_fleet):
    _, _, ck = trained_fleet
    with pytest.raises(ValueError, match="trained on arch"):
        serving_params_from_checkpoint(ck, T_R.get_smoke_config("gemma2-2b"),
                                       device="cpu")
    cfg = T_R.get_smoke_config("smollm-135m")
    with pytest.raises(ValueError, match="out of range"):
        serving_params_from_checkpoint(ck, cfg, worker=99, device="cpu")
    with pytest.raises(ValueError, match="flat width"):
        serving_params_from_checkpoint(
            ck, dataclasses.replace(cfg, d_ff=cfg.d_ff * 2), device="cpu")
    if not torch.cuda.is_available():
        for call in (lambda: serving_params_from_checkpoint(ck, cfg),
                     lambda: engine_from_checkpoint(ck, cfg)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


@pytest.fixture(scope="module")
def port_fleet(tmp_path_factory):
    """A tiny LM fleet trained by the port, and its latest snapshot."""
    from repro_torch.checkpoint import io as T_CIO
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl import lm_worker as T_LW
    cfg = T_R.get_smoke_config("smollm-135m")
    ckdir = tmp_path_factory.mktemp("port_fleet_ck")
    run = T_LW.LMRunConfig(n_workers=3, n_rounds=4, batch=2, seq=16,
                           eval_every=2, seed=1, checkpoint_every=2,
                           checkpoint_dir=str(ckdir))
    with one_torch_thread():
        fleet, _ = T_LW.run_lm_federation(
            DySTop(V=3.0, t_thre=3, max_neighbors=3), cfg, run, device="cpu")
    ck = T_CIO.latest_checkpoint(ckdir)
    assert ck is not None and ck.name == "ckpt_round000004.npz"
    return cfg, fleet, ck


@pytest.mark.usefixtures("_one_torch_thread")
def test_bridge_serves_a_port_snapshot(port_fleet):
    """A snapshot the port wrote serves as one the JAX package wrote: worker
    rows bit for bit the fleet's, the Eq. 11 global model the fleet's
    ``alpha @ pbuf``, every request served; the JAX package's bridge reads
    the same parameters from it."""
    cfg, fleet, ck = port_fleet
    spec = T_BR.fleet_spec_for(cfg)
    for w in (0, 2):
        got = serving_params_from_checkpoint(ck, cfg, worker=w, device="cpu")
        want = T_FS.unravel_tree(fleet.pbuf[w], spec, copy=True)
        for (pa, a), (pb, b) in zip(tree_paths(got), tree_paths(want)):
            assert pa == pb and a.dtype == b.dtype
            assert torch.equal(a, b)
    glob = serving_params_from_checkpoint(ck, cfg, device="cpu")
    want = T_FS.unravel_tree(T_FS.weighted_row(
        fleet.pbuf, torch.full((3,), 1 / 3)), spec, copy=True)
    for (_, a), (_, b) in zip(tree_paths(glob), tree_paths(want)):
        assert torch.equal(a, b)
    reqs = generate_requests(TrafficConfig(n_requests=2, prompt_len=(3, 6),
                                           gen_len=(2, 4), seed=2),
                             cfg.vocab_size)
    for worker in (None, 0):
        eng = engine_from_checkpoint(ck, cfg, worker=worker, batch_slots=2,
                                     max_len=32, device="cpu")
        rids = [eng.submit(r.prompt, r.gen) for r in reqs]
        out = eng.run()
        assert [len(out[i]) for i in rids] == [r.gen.max_new_tokens
                                               for r in reqs]
    pytest.importorskip("jax")
    from repro.models import registry as R_R
    from repro.serving import bridge as R_BR
    ref = R_BR.serving_params_from_checkpoint(
        ck, R_R.get_smoke_config("smollm-135m"), worker=2)
    for (_, a), b in zip(tree_paths(serving_params_from_checkpoint(
            ck, cfg, worker=2, device="cpu")), _leaves(ref)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      b.astype(np.float32))


# -- launch/serve.py -------------------------------------------------------------


def test_serve_cli_runs_grok_smoke_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "grok-1-314b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "4", "--gen", "3"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(
            os.path.dirname(__file__), "..", "src")})
    assert out.returncode == 0, out.stderr
    assert "arch=grok-1-314b-smoke batch=2 device=cpu" in out.stdout


@pytest.mark.parametrize("arch", ["seamless-m4t-medium"])
def test_serve_unported_families_name_their_item(arch, capsys):
    """The encoder-decoder family serves (stub frames, the cross caches,
    ``E_prefill``): greedy sequences of the last prompt token and ``gen``
    more, and its ``arch=`` line; serving still defaults to the card."""
    seqs = T_SERVE.serve(arch, True, 1, 4, 2, device="cpu")
    assert seqs.shape == (1, 3)
    assert f"arch={arch}-smoke batch=1 device=cpu" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T_SERVE.serve("smollm-135m", True, 1, 4, 2)

"""The port's examples (``examples/torch_*.py``) run on the CPU at small
arguments, each through ``runpy`` as a user runs it (``--device cpu``), and
print the reference example's lines.  The simulation examples' control
plane (rounds, simulated time, comm, staleness: the columns they print, and
the rest of the history's control fields) equals the JAX package's for the
same ``SimConfig`` and mechanism, bit for bit: the control plane does not
depend on the model's values, so the reference runs on its default backend
where its example asks for interpret-mode Pallas, and one round per
dispatch.
"""
import dataclasses
import pathlib
import runpy
import sys

import numpy as np
import pytest

from repro_torch.core import baselines as T_BL
from repro_torch.core import protocol as T_PROTO
from repro_torch.dfl import simulator as T_SIM
from test_torch_resume import _one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONTROL = ("rounds", "sim_time", "comm_gb", "staleness_avg",
           "staleness_max", "round_durations", "round_active")

# each example's small arguments and the start of its last printed line
CASES = {
    "quickstart": ([], "wall-clock: "),
    "dfl_federation": (["--sim-time", "100", "--workers", "8"], None),
    "dfl_lm": (["--workers", "3", "--rounds", "6", "--batch", "2",
                "--seq", "16"], "engine: "),
    "serve_lm": (["--arch", "smollm-135m", "--steps", "10"],
                 "greedy continuation: "),
    "serving_engine": (["--requests", "5"], "  req 3: "),
}


class _Recorded(T_PROTO.DySTop):
    """DySTop remembering its constructor's keywords."""
    def __init__(self, **kw):
        super().__init__(**kw)
        self.ref = ("dystop", kw)


def _record_runs(monkeypatch):
    """Patch the port's mechanism constructors and ``run_simulation`` so
    each run leaves (mechanism name and keywords, config, history)."""
    runs = []

    def get_mechanism(name, **kw):
        m = orig_get(name, **kw)
        m.ref = (name, kw)
        return m

    def run_simulation(mech, cfg, *args, **kw):
        hist = orig_run(mech, cfg, *args, **kw)
        runs.append((mech.ref, cfg, hist))
        return hist

    orig_get, orig_run = T_BL.get_mechanism, T_SIM.run_simulation
    monkeypatch.setattr(T_BL, "get_mechanism", get_mechanism)
    monkeypatch.setattr(T_PROTO, "DySTop", _Recorded)
    monkeypatch.setattr(T_SIM, "run_simulation", run_simulation)
    return runs


def _reference_control(ref, cfg):
    """The JAX package's history for the same mechanism and config, one
    round per dispatch (fewer shapes to compile; no horizon changes a
    trajectory, as ``tests/test_torch_arena.py`` runs it too)."""
    pytest.importorskip("jax")
    from repro.core import baselines as R_BL
    from repro.dfl import simulator as R_SIM
    names = {f.name for f in dataclasses.fields(R_SIM.SimConfig)}
    kw = {k: v for k, v in dataclasses.asdict(cfg).items()
          if k in names and k != "kernels"}
    kw["scan_horizon"] = 1
    name, mkw = ref
    return R_SIM.run_simulation(R_BL.get_mechanism(name, **mkw),
                                R_SIM.SimConfig(**kw))


@pytest.mark.parametrize("name", list(CASES))
def test_example_runs_on_cpu(name, monkeypatch, capsys):
    argv, last = CASES[name]
    runs = _record_runs(monkeypatch)
    path = ROOT / "examples" / f"torch_{name}.py"
    monkeypatch.setattr(sys, "argv", [str(path), *argv, "--device", "cpu"])
    runpy.run_path(str(path), run_name="__main__")
    lines = capsys.readouterr().out.strip().splitlines()
    if last is not None:
        assert lines[-1].startswith(last), lines[-1]
    if name == "quickstart":
        assert lines[0].split() == ["round", "sim-time(s)", "comm(GB)",
                                    "acc(global)", "stale(avg/max)"]
        assert len(lines) == 1 + 4 + 2          # 4 evals, a blank, a summary
    if name == "dfl_federation":
        assert lines[0].split()[:4] == ["mechanism", "phi", "rounds",
                                        "final-acc"]
        assert [ln.split()[:2] for ln in lines[1:9]] == [
            [m, phi] for phi in ("1.0", "0.4")
            for m in ("dystop", "sa-adfl", "asydfl", "matcha")]
    if name in ("quickstart", "dfl_federation"):
        assert len(runs) == {"quickstart": 1, "dfl_federation": 8}[name]
        for ref, cfg, hist in runs:
            want = _reference_control(ref, cfg)
            for f in CONTROL:
                assert getattr(hist, f) == getattr(want, f), (ref, f)
            assert np.isfinite(hist.acc_global).all()
    if name == "dfl_lm":
        losses = [float(ln.split("global-loss ")[1].split()[0])
                  for ln in lines if ln.startswith("round ")]
        assert len(losses) == 2 and np.isfinite(losses).all()
    if name == "serve_lm":
        assert "checkpoint round-trip OK" in lines
    if name == "serving_engine":
        assert lines[0].startswith("5 requests on 4 slots -> ")


def test_examples_default_to_the_card(monkeypatch):
    """Without ``--device`` an example asks for the card, and raises where
    PyTorch sees none."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    path = ROOT / "examples" / "torch_serving_engine.py"
    monkeypatch.setattr(sys, "argv", [str(path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runpy.run_path(str(path), run_name="__main__")

"""``scripts/torch_chaos_check.py``, the port's kill-and-resume check, on
the CPU: the simulation plane's cycle as a user runs it (a subprocess,
``--plane sim --device cpu``: a checkpointing child SIGKILLed once its
first snapshot exists, the resume from the oldest snapshot left against an
uninterrupted run), and its uninterrupted run's control plane against the
JAX package's ``scripts/chaos_check.py::_sim_run``, bit for bit.  Where the
kill lands depends on timing, so nothing here requires it mid-run; the LM
plane's cycle runs on the card (``chip_smoke.py`` phase 43).
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

from test_torch_resume import _one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sim_cycle_passes_on_cpu(tmp_path):
    out = tmp_path / "chaos.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_chaos_check.py"),
         "--plane", "sim", "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    art = json.loads(out.read_text())
    assert art["suite"] == "chaos_check" and art["passed"]
    (rec,) = art["records"]
    assert rec["plane"] == "sim" and rec["passed"] and not rec["mismatches"]
    assert rec["resume_from"].startswith("ckpt_round")
    assert rec["final_round"] == 60
    assert [p.name for p in tmp_path.iterdir()] == ["chaos.json"]


def test_uninterrupted_sim_run_matches_reference_control_plane():
    pytest.importorskip("jax")
    twin, ref = _load("torch_chaos_check"), _load("chaos_check")
    assert (twin.SIM_KW, twin.LM_KW, twin.CKPT_EVERY) == (
        ref.SIM_KW, ref.LM_KW, ref.CKPT_EVERY)
    assert twin.CONTROL_FIELDS == ref.CONTROL_FIELDS
    got, want = twin._sim_run("cpu"), ref._sim_run()
    for f in twin.CONTROL_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def test_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_chaos_check.py"),
         "--plane", "sim"], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "device='cpu'" in res.stderr

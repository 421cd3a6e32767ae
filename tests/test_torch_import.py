"""The PyTorch port stands alone: it imports with jax absent, never imports
jax or the JAX package, and runs on the card unless asked for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = ("repro_torch",) + path.relative_to(PORT).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_port_imports_with_jax_absent():
    mods = _port_modules()
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            + "".join(f"import {m}\n" for m in mods))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 15
    # the mesh slice's modules, the baselines, the convergence bound,
    # checkpointing, the hybrid, vlm and encoder-decoder families and the
    # trainer with its step functions are among those imported and scanned
    assert {"repro_torch.sharding.rules", "repro_torch.launch.mesh",
            "repro_torch.core.baselines", "repro_torch.core.convergence",
            "repro_torch.checkpoint", "repro_torch.checkpoint.io",
            "repro_torch.models.rglru",
            "repro_torch.configs.recurrentgemma_2b",
            "repro_torch.models.encdec", "repro_torch.configs.paligemma_3b",
            "repro_torch.configs.seamless_m4t_medium",
            "repro_torch.launch.steps", "repro_torch.launch.train"
            } <= set(mods)


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")]
    + [ROOT / "chip_smoke.py", ROOT / "chip_pods_ab.py"]
    + list((ROOT / "examples").glob("torch_*.py"))
    + list((ROOT / "scripts").glob("torch_*.py"))),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_run_simulation_defaults_to_the_card():
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    cfg = SimConfig(n_workers=4, n_rounds=2, n_samples=400, hidden=8)
    assert cfg.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_simulation(DySTop(), cfg)
    h = run_simulation(DySTop(), cfg, device="cpu")
    assert h.rounds == [2]


@pytest.mark.parametrize("kw, item", [
    (dict(fused_engine=False), 4),
    (dict(mesh_shards=2, fused_engine=False), 4)])
def test_unported_paths_name_their_roadmap_item(kw, item):
    """The settings that raised ``NotImplementedError`` naming Queue A
    ``item`` until it was ported: the legacy per-leaf path now constructs
    and runs, and with a mesh it raises ``ValueError`` when the run starts,
    as the JAX package's does."""
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    cfg = SimConfig(n_workers=4, n_rounds=2, n_samples=400, hidden=8, **kw)
    if cfg.mesh_shards > 1:
        with pytest.raises(ValueError, match="fused engine"):
            run_simulation(DySTop(), cfg, device="cpu")
    else:
        h = run_simulation(DySTop(), cfg, device="cpu")
        assert h.rounds == [2] and np.isfinite(h.acc_global).all()


def test_use_kernel_alias_warns_and_changes_nothing():
    """The JAX package's deprecated ``use_kernel`` boolean: the tensor's
    device picks the kernel here, so it warns and the run is the same."""
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    kw = dict(n_workers=6, n_rounds=6, n_samples=600, hidden=8,
              eval_every=3)
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        cfg = SimConfig(use_kernel=True, **kw)
    got = run_simulation(DySTop(), cfg, device="cpu")
    want = run_simulation(DySTop(), SimConfig(**kw), device="cpu")
    for f in ("rounds", "sim_time", "comm_gb", "round_active",
              "acc_global", "loss_global"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("kw", [
    dict(failure_prob=1.5), dict(lr=0.0), dict(n_workers=0),
    dict(pipeline_depth=-1), dict(checkpoint_every=-1),
    dict(checkpoint_every=3), dict(kernels="pallas"), dict(device="tpu")])
def test_simconfig_rejects_out_of_range(kw):
    from repro_torch.dfl.simulator import SimConfig
    with pytest.raises(ValueError):
        SimConfig(**kw)


@pytest.mark.parametrize("p_blk", [0, 48, 2048, True])
def test_kernel_config_checks_the_warp_multiple(p_blk):
    from repro_torch.kernels.config import KernelConfig
    with pytest.raises(ValueError, match="multiple of 32"):
        KernelConfig(agg_p_blk=p_blk)

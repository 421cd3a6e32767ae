"""The port's trainer, ``launch/train.py``, and its step functions.

``make_train_step`` is held against the JAX package's on smollm-135m's
smoke geometry in f32, from the reference's params over three steps on the
same batches: losses and ``grad_norm`` within rtol 1e-4.  ``train`` takes
two steps on the CPU for one architecture of each family with a trainer
path (dense, ssm, hybrid, moe, vlm, enc-dec), its checkpoint reading back
bit for bit; its default device is the card.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import lm_batches as r_lm_batches  # noqa: E402
from repro.data.synthetic import make_token_stream as r_stream  # noqa: E402
from repro.launch import steps as R_S  # noqa: E402
from repro.models import registry as R_R  # noqa: E402
from repro.optim import get_optimizer as r_get_optimizer  # noqa: E402
from repro_torch.checkpoint import io as CIO  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.dfl import flat_state as T_FS  # noqa: E402
from repro_torch.launch import steps as T_S  # noqa: E402
from repro_torch.launch import train as T_TRAIN  # noqa: E402
from repro_torch.models import registry as T_R  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.tree import tree_map, tree_paths  # noqa: E402
from test_torch_resume import _one_torch_thread  # noqa: E402,F401

FAMILIES = [("smollm-135m", "dense", 32), ("mamba2-2.7b", "ssm", 64),
            ("recurrentgemma-2b", "hybrid", 32), ("grok-1-314b", "moe", 32),
            ("paligemma-3b", "vlm", 32), ("seamless-m4t-medium", "encdec", 32)]


def _jax_params(cfg, seed=0):
    params, _ = R_R.init_params(cfg, jax.random.PRNGKey(seed))
    items = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
              np.asarray(leaf))
             for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]]
    return params, T_FS.params_from_reference(items, "cpu")


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_train_step_matches_reference(optimizer):
    r_cfg = dataclasses.replace(R_R.get_smoke_config("smollm-135m"),
                                dtype="float32")
    t_cfg = dataclasses.replace(T_R.get_smoke_config("smollm-135m"),
                                dtype="float32")
    r_params, t_params = _jax_params(r_cfg)
    r_opt, t_opt = r_get_optimizer(optimizer, 3e-4), get_optimizer(optimizer,
                                                                   3e-4)
    r_state, t_state = r_opt.init(r_params), t_opt.init(t_params)
    r_step = jax.jit(R_S.make_train_step(r_cfg, r_opt, remat=False))
    t_step = T_S.make_train_step(t_cfg, t_opt)
    batches = r_lm_batches(r_stream(r_cfg.vocab_size, 20_000), 2, 32)
    for _ in range(3):
        b = next(batches)
        r_params, r_state, r_m = r_step(r_params, r_state,
                                        {k: jnp.asarray(v)
                                         for k, v in b.items()})
        t_params, t_state, t_m = t_step(t_params, t_state,
                                        {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        assert set(t_m) == set(r_m) == {"ce", "moe_aux", "loss",
                                        "grad_norm"}
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(t_m[k]), float(r_m[k]),
                                       rtol=1e-4, err_msg=k)
        assert t_m["grad_norm"].dtype == torch.float32
    for (_, got), want in zip(tree_paths(t_params), jax.tree.leaves(r_params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_remat_names_its_roadmap_item():
    cfg = T_R.get_smoke_config("smollm-135m")
    with pytest.raises(NotImplementedError, match="Queue A item 8\\(b\\)"):
        T_S.make_train_step(cfg, get_optimizer("adam"), remat=True)


def test_prefill_and_serve_steps():
    cfg = T_R.get_smoke_config("smollm-135m")
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    logits = T_S.make_prefill_step(cfg)(params, {"tokens": tokens})
    assert logits.shape[:2] == (2, 8) and torch.isfinite(logits).all()
    cache = T_R.init_decode_cache(cfg, ShapeSpec("d", 16, 2, "decode"),
                                  "cpu")
    step = T_S.make_serve_step(cfg)
    for i in range(8):
        out, cache = step(params, cache, tokens[:, i:i + 1])
    # decoding the prompt token by token ends on prefill's last logits
    np.testing.assert_allclose(out[:, 0].float().numpy(),
                               logits[:, -1].float().numpy(), atol=0.1)


@pytest.mark.parametrize("arch, family, seq", FAMILIES,
                         ids=[f[1] for f in FAMILIES])
def test_train_every_family_on_the_cpu(tmp_path, arch, family, seq):
    ck = tmp_path / "final.npz"
    run = T_TRAIN.train(arch, True, 2, 2, seq, ckpt_path=str(ck),
                        device="cpu", return_run=True, log_every=1)
    assert T_R.get_smoke_config(arch).family in (family, "audio")
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()
    template = tree_map(torch.zeros_like, run.params)
    params, opt, extra = CIO.load_checkpoint(
        ck, template, tree_map(torch.zeros_like, run.opt_state))
    for (_, got), (_, want) in zip(tree_paths(params),
                                   tree_paths(run.params)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(opt["step"], run.opt_state["step"])
    assert extra["final_loss"] == run.losses[-1] and extra["steps"] == 2


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T_TRAIN.train("smollm-135m", True, 1, 1, 8)


def test_train_command_line(tmp_path):
    """``python -m repro_torch.launch.train`` with the reference's flags and
    ``--device cpu`` trains and writes its checkpoint."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    ck = tmp_path / "cli.npz"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--ckpt", str(ck)],
        env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert "loss: first10" in res.stdout and ck.exists()

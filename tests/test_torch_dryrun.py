"""The dry-run tools against the JAX package: the step's own cost counter
(``launch.loopcost.step_costs``) against ``jaxpr_costs(scan_once=False)``,
each kernel's cost formula against ``PERF.md``'s bounds, the model FLOPs
estimate (``launch.analysis``), the same step counted on ``meta`` and on
the CPU, and ``launch.dryrun.run_one`` at full width on ``meta``.
"""
import json
import math

import pytest
import torch

from repro_torch.configs.base import INPUT_SHAPES, ShapeSpec
from repro_torch.launch import analysis as T_A
from repro_torch.launch import dryrun as T_D
from repro_torch.launch import loopcost as LC
from repro_torch.launch import steps as T_S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import registry as T_R
from repro_torch.optim import get_optimizer
from test_torch_resume import _one_torch_thread  # noqa: F401

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import analysis as R_A  # noqa: E402
from repro.launch import loopcost as R_LC  # noqa: E402
from repro.models import registry as R_R  # noqa: E402

FAMILY_ARCHS = ("smollm-135m", "mamba2-2.7b", "recurrentgemma-2b",
                "grok-1-314b", "paligemma-3b", "seamless-m4t-medium")
N, TRIPS = 64, 7
ROOF_KEYS = {"arch", "shape", "mesh", "mode", "flops_per_device",
             "bytes_per_device", "collective_bytes_per_device",
             "collectives", "collective_bytes_by_kind",
             "peak_memory_per_device", "model_flops", "t_compute",
             "t_memory", "t_collective", "bottleneck", "useful_flops_ratio",
             "optimizer", "trace_s", "mesh_devices"}


def _loop(x, w):
    for _ in range(TRIPS):
        x = x @ w
    return x


def _ref_loop(x, w):
    return jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=TRIPS)[0]


def _grad(x, w):
    x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
    return torch.autograd.grad(_loop(x, w).sum(), (x, w))


def test_step_costs_match_jaxpr_costs():
    x, w = torch.randn(N, N), torch.randn(N, N)
    sds = jax.ShapeDtypeStruct((N, N), jnp.float32)
    fwd = LC.step_costs(_loop, x, w)
    r_flops, r_bytes = R_LC.jaxpr_costs(_ref_loop, sds, sds, scan_once=False)
    assert fwd.dot_flops == TRIPS * 2 * N ** 3 == r_flops
    assert fwd.io_bytes == r_bytes           # one (N,N)x(N,N) op per trip
    assert fwd.arg_bytes == 2 * N * N * 4
    # both arguments' gradients: each trip's backward is two products
    grad = LC.step_costs(_grad, x, w)
    r_flops, _ = R_LC.jaxpr_costs(
        jax.grad(lambda a, b: _ref_loop(a, b).sum(), argnums=(0, 1)),
        sds, sds, scan_once=False)
    assert grad.dot_flops == 3 * TRIPS * 2 * N ** 3 == r_flops
    # the same counts on meta
    meta = LC.step_costs(_grad, x.to("meta"), w.to("meta"))
    assert (meta.dot_flops, meta.io_bytes, meta.peak_bytes) == (
        grad.dot_flops, grad.io_bytes, grad.peak_bytes)


def test_peak_follows_live_storages():
    def fn(x):
        y = x * 2                       # 4 KB live
        z = y + 1                       # 8 KB live
        del y                           # 4 KB
        return (z * 3).sum()            # 8 KB and the 4-byte sum at the peak
    c = LC.step_costs(fn, torch.ones(1024))
    assert c.arg_bytes == 4096
    assert c.peak_bytes == 4096 * 3 + 4
    assert c.activation_peak_bytes == 4096 * 2 + 4


def test_kernel_costs_pin_perf_md_bounds():
    """Three rows of ``PERF.md``'s kernel table, through the formulas
    that ``chip_smoke.py`` and the counter share."""
    agg = LC.agg_cost(torch.ones((2, 8)), None, 134_515_008, 8)
    assert agg.bound()[1] == "bytes"
    assert round(agg.bound()[0], 3) == 1.606
    q = torch.empty((4, 9, 256, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((4, 3, 256, 64), dtype=torch.bfloat16, device="meta")
    fa = LC.flash_cost(q, k, True, None)
    assert fa.bound()[1] == "bytes"
    assert round(fa.bound()[0], 6) == 0.000939
    ssd = LC.ssd_cost(8, 80, 256, 128, 64)
    assert ssd.bound()[1] == "operations"
    assert round(ssd.bound()[0], 4) == 0.0412
    # the closed-form pair count against a materialised mask
    for s, causal, window in [(37, True, None), (37, False, 5),
                              (37, True, 8), (37, False, -4), (9, True, 0)]:
        rows = torch.arange(s)[:, None]
        cols = torch.arange(s)[None, :]
        mask = torch.ones((s, s), dtype=torch.bool)
        if causal:
            mask &= cols <= rows
        if window is not None:
            mask &= (rows - cols) < window
        assert LC.attention_pairs(s, causal, window) == int(mask.sum())
    # aggregate's data: zero columns and repeated ids count once
    W = torch.tensor([[0.5, 0.0, 0.5], [1.0, 0.0, 0.0]])
    ids = torch.tensor([4, 0, 4], dtype=torch.int32)
    data, dense = (LC.agg_cost(W, ids, 10, 8, data=d) for d in (True, False))
    assert (data.flops, dense.flops) == (2 * 2 * 2 * 10, 2 * 2 * 3 * 10)
    assert dense.nbytes - data.nbytes == 10 * 4


class _Xpu(torch.Tensor):
    """A tensor that says it lies on a device with no kernel here."""
    @property
    def device(self):
        return torch.device("xpu")


def _kernel_calls(dev):
    """Each kernel entry point once on small inputs on ``dev`` ("cpu",
    "meta" or "xpu": CPU tensors that say they lie on an xpu)."""
    from repro_torch.dfl import flat_state as FS
    from repro_torch.kernels import (aggregate, flash_attention, fused_sgd,
                                     moe_router, ssd_chunk)

    def t(*shape, dtype=torch.float32):
        x = torch.zeros(shape, dtype=dtype, device="cpu" if dev == "xpu"
                        else dev)
        return torch.Tensor._make_subclass(_Xpu, x) if dev == "xpu" else x

    spec = FS.spec_of({"b1": torch.zeros((1, 4)), "b2": torch.zeros((1, 4)),
                       "b3": torch.zeros((1, 3)), "w1": torch.zeros((1, 2, 4)),
                       "w2": torch.zeros((1, 4, 4)),
                       "w3": torch.zeros((1, 4, 3))})
    return {
        "aggregate": lambda: aggregate.aggregate(t(2, 3), t(3, 5)),
        "flash_attention": lambda: flash_attention.flash_attention(
            t(1, 2, 8, 8), t(1, 1, 8, 8), t(1, 1, 8, 8)),
        "ssd_chunk": lambda: ssd_chunk.ssd_chunk(t(1, 4, 2), t(1, 4, 2),
                                                 t(1, 2, 4), t(1, 2, 4, 64)),
        "moe_router": lambda: moe_router.moe_router(t(3, 4), 2),
        "fused_sgd": lambda: fused_sgd.fused_sgd(
            t(2, spec.n_params), t(2, 1, 3, 2), t(2, 1, 3, dtype=torch.int32),
            t(2), spec, 0.1),
    }


def test_kernel_entry_points_on_meta_and_elsewhere():
    """``meta`` gives empty outputs shaped and typed as the CPU's, and is
    counted by each kernel's formula; any device but the CPU, a card or
    ``meta`` is refused: no kernel falls back to its plain version."""
    cpu, meta = _kernel_calls("cpu"), _kernel_calls("meta")
    for name, call in _kernel_calls("xpu").items():
        with pytest.raises(ValueError, match="no kernel for device xpu"):
            call()
        want = cpu[name]()
        with LC.CostCounter() as c:
            got = meta[name]()
        got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
        assert [(g.device.type, g.shape, g.dtype) for g in got] == [
            ("meta", w.shape, w.dtype) for w in want], name
        assert dict(c.kernel_calls) == {name: 1} and c.io_bytes > 0, name


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_model_flops_estimate_matches_reference(shape):
    for arch in R_R.ARCH_IDS:
        assert T_A.model_flops_estimate(
            T_R.get_config(arch), INPUT_SHAPES[shape]) == \
            R_A.model_flops_estimate(R_R.get_config(arch),
                                     R_R.INPUT_SHAPES[shape])


def _random_batch(specs, vocab):
    gen = torch.Generator().manual_seed(0)
    return {k: (torch.randint(0, vocab, v.shape, generator=gen,
                              dtype=v.dtype) if v.dtype == torch.int32
                else torch.rand(v.shape, generator=gen).to(v.dtype))
            for k, v in specs.items()}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_smoke_train_step_counts_the_same_on_meta_and_cpu(arch):
    cfg = T_R.get_smoke_config(arch)
    shape = ShapeSpec("smoke", 64, 2, "train")
    opt = get_optimizer("adam")
    art = T_S.build_train_artifacts(cfg, shape, make_host_mesh("cpu"), opt)
    counts = []
    for gen in (None, torch.Generator().manual_seed(0)):
        params = T_R.init_params(cfg, gen)
        batch = T_R.batch_specs(cfg, shape)
        if gen is not None:
            batch = _random_batch(batch, cfg.vocab_size)
        c = LC.step_costs(art.step_fn, params, opt.init(params), batch)
        counts.append((c.dot_flops, c.io_bytes, c.peak_bytes, c.arg_bytes,
                       dict(c.kernel_calls)))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][1] > 0


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_run_one_full_width_on_meta(arch, tmp_path):
    rec = T_D.run_one(arch, "train_4k", "multi", verbose=False,
                      out_dir=tmp_path)
    assert json.loads((tmp_path / f"{arch}_train_4k_multi.json")
                      .read_text()) == rec
    assert set(rec) == ROOF_KEYS
    assert rec["mesh_devices"] == 512 and rec["mode"] == "train"
    for k in ("flops_per_device", "bytes_per_device", "t_compute",
              "t_memory", "peak_memory_per_device", "useful_flops_ratio"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    assert rec["t_collective"] is None
    assert rec["bottleneck"] in ("compute", "memory")
    assert rec["model_flops"] == R_A.model_flops_estimate(
        R_R.get_config(arch), R_R.INPUT_SHAPES["train_4k"])
    # long_500k is skipped exactly where the reference skips it
    long = T_D.run_one(arch, "long_500k", "multi", verbose=False,
                       out_dir=tmp_path)
    assert ("skipped" in long) == (not R_R.long_context_capable(
        R_R.get_config(arch)))


def test_run_one_paper_mode(tmp_path):
    rec = T_D.run_one("smollm-135m", "train_4k", "single", paper_mode=True,
                      local_steps=2, verbose=False, out_dir=tmp_path)
    assert rec["mode"] == "dystop_round" and rec["mesh"] == "multi"
    assert (tmp_path / "smollm-135m_train_4k_multi_dystop.json").exists()
    one = T_D.run_one("smollm-135m", "train_4k", "multi", verbose=False,
                      out_dir=tmp_path)
    # two pods x two local steps of half the batch, plus the pod mix
    assert rec["flops_per_device"] > 1.9 * one["flops_per_device"]
    assert "skipped" in T_D.run_one("smollm-135m", "decode_32k", "multi",
                                    paper_mode=True, verbose=False,
                                    out_dir=tmp_path)

"""The dry-run tools against the JAX package: the step's own cost counter
(``launch.loopcost.step_costs``) against ``jaxpr_costs(scan_once=False)``,
each kernel's cost formula against ``PERF.md``'s bounds, the model FLOPs
estimate (``launch.analysis``), the same step counted on ``meta`` and on
the CPU, ``launch.dryrun.run_one`` at full width on ``meta`` with the
reference's keywords, and the ladder and table scripts
(``scripts/torch_perf_hillclimb.py``, ``scripts/torch_gen_roofline_md.py``).
"""
import importlib.util
import json
import math
import pathlib

import pytest
import torch

from repro_torch.configs.base import INPUT_SHAPES, ShapeSpec
from repro_torch.launch import analysis as T_A
from repro_torch.launch import dryrun as T_D
from repro_torch.launch import loopcost as LC
from repro_torch.launch import steps as T_S
from repro_torch.launch.mesh import NVLINK_BW, make_host_mesh
from repro_torch.models import registry as T_R
from repro_torch.optim import get_optimizer
from repro_torch.sharding import rules as T_SR
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
             "optimizer", "trace_s", "mesh_devices", "attn_impl",
             "rule_overrides", "rules", "tag", "paper_ctx", "sharded"}


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
    # the dense family's train step runs sharded: one rank's own count,
    # with its collectives; the others split one unsharded count evenly
    dense = R_R.get_config(arch).family == "dense"
    assert rec["sharded"] == dense
    if dense:
        assert rec["t_collective"] > 0
        assert rec["bottleneck"] in ("compute", "memory", "collective")
    else:
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
    # the round is counted unsharded and split evenly over the 512
    # devices; one train step likewise (the host mesh's whole count, the
    # multi mesh's train record being one rank's own sharded count)
    one = T_D.run_one("smollm-135m", "train_4k", "host", verbose=False,
                      out_dir=tmp_path)
    assert not rec["sharded"] and not one["sharded"]
    # two pods x two local steps of half the batch, plus the pod mix
    assert rec["flops_per_device"] > 1.9 * one["flops_per_device"] / 512
    assert "skipped" in T_D.run_one("smollm-135m", "decode_32k", "multi",
                                    paper_mode=True, verbose=False,
                                    out_dir=tmp_path)


def _script(name):
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
        f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_one_takes_the_reference_keywords(tmp_path):
    """``rule_overrides``, ``attn_impl``, ``tag`` and ``paper_ctx`` are
    accepted with the reference's meaning and written into the record; the
    tag names the file.  On the prefix-LM ``attn_impl="chunked"`` moves the
    count; the rules move the resident bytes a device holds, not the
    count."""
    kw = dict(verbose=False, out_dir=tmp_path)
    base = T_D.run_one("paligemma-3b", "train_4k", "single", **kw)
    rec = T_D.run_one("paligemma-3b", "train_4k", "single",
                      rule_overrides={"embed": None}, attn_impl="chunked",
                      tag="kw", paper_ctx=False, **kw)
    path = tmp_path / "paligemma-3b_train_4k_single_kw.json"
    assert json.loads(path.read_text()) == rec
    assert (rec["attn_impl"], rec["rule_overrides"], rec["tag"],
            rec["paper_ctx"]) == ("chunked", {"embed": None}, "kw", False)
    assert (base["attn_impl"], base["rule_overrides"], base["tag"],
            base["paper_ctx"]) == ("naive", None, "", True)
    defaults = {k: None if v is None else list(v)
                for k, v in T_SR.DEFAULT_RULES.items()}
    assert base["rules"] == defaults
    assert rec["rules"] == {**defaults, "embed": None}
    assert rec["bytes_per_device"] != base["bytes_per_device"]
    assert rec["peak_memory_per_device"] > base["peak_memory_per_device"]
    same = T_D.run_one("paligemma-3b", "train_4k", "single",
                       attn_impl="chunked", **kw)
    assert same["bytes_per_device"] == rec["bytes_per_device"]
    # paper mode: a tag replaces "_dystop"; the round's builder keeps the
    # pod rule over the caller's
    rec = T_D.run_one("smollm-135m", "train_4k", "multi", paper_mode=True,
                      rule_overrides={"data": ("pod", "data"),
                                      "embed": None}, tag="p", **kw)
    assert (tmp_path / "smollm-135m_train_4k_multi_p.json").exists()
    assert rec["rule_overrides"] == {"data": ("pod", "data"), "embed": None}
    assert rec["rules"] == {**defaults, "data": ["data"], "embed": None}
    assert not (tmp_path / "smollm-135m_train_4k_multi_dystop.json").exists()


def test_h1_ladder_on_meta(tmp_path, capsys):
    """The h1 ladder's three rungs count on ``meta``, each as one rank's
    own sharded step: smollm-135m has no prefix, so "chunked" leaves flash
    in place and iteration 1 counts the FLOPs and bytes of iteration 0;
    iteration 2's ``q_seq: ("model",)`` runs the 9 heads (which do not
    split over the 16-way model axis) context-parallel where iteration 1
    ran them replicated, so it counts fewer FLOPs and bytes and more
    collective bytes; each rung prints the reference's ``emit`` line with
    a number for ``t_coll``."""
    _script("torch_perf_hillclimb").h1(verbose=False, out_dir=tmp_path)
    recs = [json.loads((tmp_path / f"smollm-135m_train_4k_single_{t}.json")
                       .read_text())
            for t in ("h1_iter0", "h1_chunked", "h1_chunked_cp")]
    assert [r["attn_impl"] for r in recs] == ["naive", "chunked", "chunked"]
    assert recs[2]["rule_overrides"] == {"q_seq": ["model"]}
    assert [r["rules"]["q_seq"] for r in recs] == [None, None, ["model"]]
    assert all(r["sharded"] for r in recs)
    assert (recs[1]["flops_per_device"], recs[1]["bytes_per_device"]) == (
        recs[0]["flops_per_device"], recs[0]["bytes_per_device"])
    assert recs[2]["flops_per_device"] < recs[1]["flops_per_device"]
    assert recs[2]["bytes_per_device"] < recs[1]["bytes_per_device"]
    assert (recs[2]["collective_bytes_per_device"]
            > recs[1]["collective_bytes_per_device"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "== h1_iter0_baseline", "== h1_iter1_chunked",
        "== h1_iter2_chunked_cp"]
    for ln, r in zip(lines, recs):
        assert f"t_coll={r['t_collective'] * 1e3:.1f}ms" in ln
        assert "bottleneck=memory" in ln


@pytest.mark.parametrize("arch", T_R.DENSE_ARCH_IDS)
def test_dense_prefill_is_counted_sharded_on_both_meshes(arch, tmp_path):
    """Every dense arch's prefill on the single and the multi mesh is one
    rank's own sharded count: a collective term, the vocab-split logits'
    block on the rank (its peak far below the unsharded step's), and the
    decode shape of the same arch still split evenly (item 9(c))."""
    kw = dict(verbose=False, out_dir=tmp_path)
    for mesh in ("single", "multi"):
        rec = T_D.run_one(arch, "prefill_32k", mesh, **kw)
        assert rec["sharded"] and rec["mode"] == "prefill"
        assert rec["t_collective"] > 0
        assert rec["collective_bytes_by_kind"]["all-gather"] > 0
    host = T_D.run_one(arch, "prefill_32k", "host", **kw)
    assert not host["sharded"]
    assert rec["peak_memory_per_device"] < host["peak_memory_per_device"]
    dec = T_D.run_one(arch, "decode_32k", "single", **kw)
    assert not dec["sharded"] and dec["t_collective"] is None


def test_collective_bytes_match_the_closed_form(tmp_path):
    """smollm-135m ``train_4k`` on the single mesh (data 16 x model 16),
    one rank's sharded step: its collective calls and bytes by kind equal
    the closed form from the specs.  Per rank: batch 256 / 16 = 16 rows of
    4096; d_model 576 split 16 ways over data (FSDP), d_ff 1536 and the
    padded vocab 49,152 over model, the 9 heads and 3 kv heads not (the
    attention runs replicated); 30 layers, each its own remat group; bf16
    weights, f32 norm scales.

    * all-gather (FSDP): each layer's 9 leaves whole over data, in the
      forward and again in the backward's recompute, plus the embedding
      table and the final norm once;
    * reduce-scatter: each of those leaves' gradient once (its local
      block);
    * all-reduce: the vocab-split embedding's psum, each layer's MLP
      down-projection psum (f32: the partial sums are summed unrounded;
      forward only: the recompute stops at the last tensor the backward
      saves, before it), each layer's MLP input
      gradient (f32: the norm's held output) and the LM head's input
      gradient (bf16), the cross-entropy's max, sum of exponentials and
      label logit over model (f32 per token), its numerator and
      denominator over data, and ``grad_norm``'s sum over data and over
      model (f32 scalars)."""
    rec = T_D.run_one("smollm-135m", "train_4k", "single", verbose=False,
                      out_dir=tmp_path)
    b, s, d, dl, f, v, layers = 16, 4096, 576, 36, 96, 3072, 30
    bf, f4 = 2, 4
    whole = (2 * d * f4                               # ln1, ln2
             + 2 * d * 9 * 64 * bf + 2 * d * 3 * 64 * bf   # wq wo, wk wv
             + 3 * d * f * bf)                        # the MLP
    act = b * s * d
    want = {
        "all-gather": 2 * layers * whole + v * d * bf + d * f4,
        "reduce-scatter": layers * whole // 16 + v * dl * bf + dl * f4,
        "all-reduce": (act * bf + layers * act * f4 + layers * act * f4
                       + act * bf + 3 * b * s * f4 + 2 * f4 + 2 * f4)}
    assert rec["collective_bytes_by_kind"] == want
    assert rec["collectives"] == {"all-gather": 2 * layers * 9 + 2,
                                  "reduce-scatter": layers * 9 + 2,
                                  "all-reduce": 1 + 2 * layers + 1 + 3 + 4}
    assert rec["collective_bytes_per_device"] == sum(want.values())
    assert rec["t_collective"] == sum(want.values()) / NVLINK_BW


def test_roofline_table_skips_tagged_records(tmp_path):
    kw = dict(verbose=False, out_dir=tmp_path)
    T_D.run_one("smollm-135m", "decode_32k", "single", **kw)
    T_D.run_one("smollm-135m", "decode_32k", "host", **kw)
    T_D.run_one("smollm-135m", "decode_32k", "single", tag="x", **kw)
    gen = _script("torch_gen_roofline_md")
    recs = gen.load(tmp_path)
    assert len(recs) == 2
    table = gen.fmt(recs, "single").splitlines()
    assert len(table) == 3 and table[0].startswith("| arch | shape | mode")
    row = table[2].split(" | ")
    assert row[:3] == ["| smollm-135m", "decode_32k", "serve"]
    assert row[5] == "n/a" and row[6] == "**memory**"
    assert "VMEM" not in table[2] and "MXU" not in table[2]
    assert len(gen.fmt(recs, "host").splitlines()) == 3
    assert not any("VMEM" in t or "MXU" in t for t in gen.REMEDY.values())

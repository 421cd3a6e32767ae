"""The port's serving engine, held against the JAX package's ``ServeEngine``.

Both engines serve the same requests (the port's ``generate_requests``,
the same numpy draws as the reference's) from the reference's init, jax
pinned to its CPU backend, the port with ``device="cpu"``.  Greedy streams:
identical on the f32 smoke variants of smollm-135m, gemma2-2b, mamba2-2.7b
and grok-1-314b; in bf16 a stream may leave the reference's only at a step
where the reference's own top-2 logit gap is under 0.1 (the decode
tolerance of ``tests/test_torch_decode.py``), and such steps are counted.
Sampling draws from the port's own generators (the reference's threefry
draws are not reproduced), so sampled modes are held to the properties the
reference's ``tests/test_serving.py`` pins.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.dfl import flat_state as T_FS
from repro_torch.models import registry as T_R
from repro_torch.serving import (GenerationConfig, ServeEngine,
                                 TrafficConfig, generate_requests)
from repro_torch.serving.engine import request_generator, sample_token
from test_torch_resume import _one_torch_thread  # noqa: F401

BF16_TOL = 0.1
ENGINE_ARCHS = ("smollm-135m", "gemma2-2b", "mamba2-2.7b", "grok-1-314b")


def _paths(tree):
    import jax
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             np.asarray(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _reference(arch, dtype, seed=0):
    """(jax cfg, jax params, port cfg, port params) from the reference's
    init."""
    jax = pytest.importorskip("jax")
    from repro.models import registry as R_R
    r_cfg = dataclasses.replace(R_R.get_smoke_config(arch), dtype=dtype)
    with jax.default_device(jax.devices("cpu")[0]):
        params, _ = R_R.init_params(r_cfg, jax.random.PRNGKey(seed))
    t_cfg = dataclasses.replace(T_R.get_smoke_config(arch), dtype=dtype)
    return (r_cfg, params, t_cfg,
            T_FS.params_from_reference(_paths(params), "cpu"))


def reference_logits(r_cfg, params, prompt, out):
    """The reference's teacher-forced logits for each generated token of a
    request: the engine feeds the prompt, then its last token again, then
    the stream (jitted ``prefill_cache`` at batch 1)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeSpec as R_Shape
    from repro.models import registry as R_R
    from repro.models import transformer as R_T
    seq = np.concatenate([prompt, prompt[-1:], out[:-1]]).astype(np.int32)
    with jax.default_device(jax.devices("cpu")[0]):
        cache = R_R.init_decode_cache(r_cfg, R_Shape("d", len(seq) + 1, 1,
                                                     "decode"))
        logits, _ = jax.jit(lambda p, c, t: R_T.prefill_cache(
            r_cfg, p, c, t))(params, cache, jnp.asarray(seq)[None])
    return np.asarray(logits)[0, len(prompt):, :r_cfg.vocab_size]


def near_tie_steps(r_cfg, params, requests, got, want, tol=BF16_TOL):
    """Check that every stream of ``got`` follows ``want`` up to a step
    where the reference's top-2 gap is under ``tol``; count those steps."""
    n = 0
    for rid, r in enumerate(requests):
        a, b = got[rid], want[rid]
        assert len(a) == len(b)
        diff = [j for j in range(len(b)) if a[j] != b[j]]
        if not diff:
            continue
        j = diff[0]
        top2 = np.sort(reference_logits(r_cfg, params, r.prompt,
                                        np.asarray(b))[j])[-2:]
        assert top2[1] - top2[0] < tol, (rid, j, top2)
        n += 1
    return n


def _requests(vocab, n=5, seed=3):
    return generate_requests(TrafficConfig(n_requests=n, prompt_len=(3, 8),
                                           gen_len=(4, 8), seed=seed), vocab)


def _serve_both(arch, dtype, slots=3):
    jax = pytest.importorskip("jax")
    from repro.serving import ServeEngine as R_Engine
    r_cfg, params, t_cfg, t_params = _reference(arch, dtype)
    reqs = _requests(r_cfg.vocab_size)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = R_Engine(r_cfg, params, batch_slots=slots, max_len=32)
        for r in reqs:
            ref.submit(r.prompt, r.gen)
        want = ref.run()
    eng = ServeEngine(t_cfg, t_params, batch_slots=slots, max_len=32,
                      device="cpu")
    for r in reqs:
        eng.submit(r.prompt, r.gen)
    got = eng.run()
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    assert all(len(got[i]) == r.gen.max_new_tokens
               for i, r in enumerate(reqs))
    assert {i: s.finish_step for i, s in eng.stats.items()} == {
        i: s.finish_step for i, s in ref.stats.items()}
    return r_cfg, params, reqs, got, want


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_greedy_streams_match_reference_f32(arch):
    _, _, _, got, want = _serve_both(arch, "float32")
    assert got == want


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_greedy_streams_match_reference_bf16(arch):
    r_cfg, params, reqs, got, want = _serve_both(arch, "bfloat16")
    n = near_tie_steps(r_cfg, params, reqs, got, want)
    assert n <= 1, f"{n} streams left the reference at a near tie"


def test_outputs_invariant_to_slot_count():
    """grok smoke (E = 4, k = 2): 12 requests through 1 slot and through 12
    slots give the same streams, greedy and sampled.  With 12 slots all
    rows decode together; a capacity shared by the batch (8 choices per
    expert for 12 tokens) would drop some, the per-row groups drop none."""
    cfg = dataclasses.replace(T_R.get_smoke_config("grok-1-314b"),
                              dtype="float32")
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    tc = TrafficConfig(n_requests=12, prompt_len=(2, 4), gen_len=(2, 4),
                       seed=5)
    outs = []
    for slots in (1, 12):
        for sampled in (False, True):
            eng = ServeEngine(cfg, params, batch_slots=slots, max_len=32,
                              seed=1, device="cpu")
            for r in generate_requests(tc, cfg.vocab_size):
                gen = (dataclasses.replace(r.gen, temperature=0.9, top_k=8)
                       if sampled else r.gen)
                eng.submit(r.prompt, gen)
            outs.append(eng.run())
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert outs[0] != outs[1]                 # sampling does sample


def test_admission_zeroes_recurrent_state():
    """A slot reused by a second request starts from a fresh row (ssm
    state and conv tail zeroed): its stream is the one it gets alone."""
    cfg = dataclasses.replace(T_R.get_smoke_config("mamba2-2.7b"),
                              dtype="float32")
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    g = GenerationConfig(max_new_tokens=5)
    prompts = [np.arange(1, 9), np.arange(20, 26)]
    eng = ServeEngine(cfg, params, batch_slots=1, max_len=32, device="cpu")
    rids = [eng.submit(p, g) for p in prompts]
    out = eng.run()
    alone = ServeEngine(cfg, params, batch_slots=1, max_len=32, device="cpu")
    rid = alone.submit(prompts[1], g)
    assert out[rids[1]] == alone.run()[rid]


def test_eos_stops_early():
    cfg = T_R.get_smoke_config("smollm-135m")
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, batch_slots=1, max_len=64, device="cpu")
    rid = eng.submit(np.arange(1, 9), GenerationConfig(max_new_tokens=8))
    first = eng.run()[rid][0]
    eng2 = ServeEngine(cfg, params, batch_slots=1, max_len=64, device="cpu")
    rid2 = eng2.submit(np.arange(1, 9),
                       GenerationConfig(max_new_tokens=8, eos_id=first))
    assert eng2.run()[rid2] == [first]
    assert eng2.last_logits.shape == (1, cfg.vocab_size)


# -- sampling -----------------------------------------------------------------


def _logits(seed, shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_sample_token_topk1_is_greedy():
    logits = _logits(3, (4, 16))
    greedy = logits.argmax(-1)
    for i in range(10):
        t = sample_token(logits, torch.Generator().manual_seed(i),
                         GenerationConfig(temperature=2.3, top_k=1))
        assert torch.equal(t, greedy)
    assert torch.equal(sample_token(logits, None, GenerationConfig()),
                       greedy)


@pytest.mark.parametrize("flt", [dict(top_p=1.0), dict(top_k=16),
                                 dict(top_k=17), dict(top_k=1000)])
def test_sample_token_noop_filters_draw_alike(flt):
    """``top_k >= V`` and ``top_p = 1`` keep every token: the same draws as
    plain temperature sampling, draw for draw."""
    logits = _logits(4, (3, 16))
    for i in range(20):
        plain = sample_token(logits, torch.Generator().manual_seed(i),
                             GenerationConfig(temperature=0.8))
        filt = sample_token(logits, torch.Generator().manual_seed(i),
                            GenerationConfig(temperature=0.8, **flt))
        assert torch.equal(plain, filt)


def test_sample_token_topk_topp_combined():
    logits = torch.tensor([[0.0, 3.0, 2.0, -1.0, 1.0]])
    seen = set()
    for i in range(60):
        t = sample_token(logits, torch.Generator().manual_seed(i),
                         GenerationConfig(temperature=2.0, top_k=2,
                                          top_p=0.95))
        seen.add(int(t[0]))
    assert seen == {1, 2}
    for i in range(10):
        t = sample_token(logits, torch.Generator().manual_seed(i),
                         GenerationConfig(temperature=2.0, top_k=2,
                                          top_p=0.01))
        assert int(t[0]) == 1


def test_sample_token_seed_determinism():
    logits = _logits(6, (2, 64))
    gen = GenerationConfig(temperature=1.0, top_k=8, top_p=0.9)
    a = sample_token(logits, request_generator(42, 7), gen)
    b = sample_token(logits, request_generator(42, 7), gen)
    assert torch.equal(a, b)
    outs = {tuple(sample_token(logits, request_generator(42, rid),
                               gen).tolist()) for rid in range(30)}
    assert len(outs) > 1                    # the request id matters
    hot = {int(sample_token(torch.tensor([[0.0, 5.0, 1.0, -2.0]]),
                            torch.Generator().manual_seed(i),
                            GenerationConfig(temperature=5.0))[0])
           for i in range(40)}
    assert hot.issubset({0, 1, 2, 3}) and len(hot) > 1


# -- entry points ---------------------------------------------------------------


def test_engine_defaults_to_the_card_and_never_moves_params():
    cfg = T_R.get_smoke_config("smollm-135m")
    params = T_R.init_params(cfg, torch.Generator().manual_seed(0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(cfg, params)
    meta = T_R.init_params(cfg, None)
    with pytest.raises(ValueError, match="params lie on meta"):
        ServeEngine(cfg, meta, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        ServeEngine(cfg, params, max_len=8, device="cpu").submit(
            np.arange(1, 6), GenerationConfig(max_new_tokens=4))

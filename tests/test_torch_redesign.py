"""The Hopper designs of ``fused_sgd`` and ``moe_router``, held on the CPU by
replaying each kernel's order of operations, and on the card by the kernels.

``fused_sgd``: a cluster of C CTAs trains one row, each CTA with its own copy
of the row in shared memory.  CTA r runs the forward and the per-sample
backward of samples [r B / C, (r + 1) B / C) and pushes those activations to
every CTA; then each CTA sums the gradients of its own weight rows over the
whole batch in sample order, updates them and pushes them to every CTA (the
last step writes them to ``out``).  ``_emulate_fused_sgd`` is an independent
f32 replay of that design in numpy: ``fmaf`` with one rounding, the
kernel's four interleaved partial sums in its dot products, the warp's
butterfly sums, one shared-memory copy per CTA and the kernel's partition of
samples, of dh1's output pairs and of the gradient jobs (2 rows x 4 columns).
It checks that the partition writes every parameter exactly once a step and
leaves every CTA's copy equal, that the result is within 1e-5 of the plain
version and of the JAX Pallas kernel (interpret mode, jax on its CPU
backend), and that the design's bits do not depend on C or on the other rows
of the call.  Its ``expf`` and ``logf`` are numpy's, not the card's, so the
kernel's own bits are held by the card-only tests.

``moe_router``: each lane of a warp (or of an 8- or 16-lane segment) sorts
its own candidates once, keeping its best min(k, NPL) by (probability,
index), and each round takes the arg-max over the lanes' heads.
``_emulate_router`` replays that on the plain version's probabilities and
must give its ids, on ties and on distinct logits whose probabilities round
equal.

The card-only tests (marker ``cuda``) run the kernels themselves.
"""
import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.dfl import flat_state as T_FS
from repro_torch.kernels import fused_sgd as T_FSGD
from repro_torch.kernels import moe_router as T_MR

F32 = np.float32


# --------------------------------------------------------------------------- #
# fused_sgd (kernel row 2)
# --------------------------------------------------------------------------- #

def _mlp_inputs(seed, k, steps, batch, d=6, h=12, g=12, c=5):
    rng = np.random.default_rng(seed)
    stacked = {
        "w1": rng.normal(size=(k, d, h)) * d ** -0.5,
        "b1": rng.normal(size=(k, h)) * 0.1,
        "w2": rng.normal(size=(k, h, g)) * h ** -0.5,
        "b2": rng.normal(size=(k, g)) * 0.1,
        "w3": rng.normal(size=(k, g, c)) * g ** -0.5,
        "b3": rng.normal(size=(k, c)) * 0.1}
    stacked = {n: v.astype(np.float32) for n, v in stacked.items()}
    xb = rng.normal(size=(k, steps, batch, d)).astype(np.float32)
    yb = rng.integers(0, c, size=(k, steps, batch)).astype(np.int32)
    active = (np.arange(k) % 3 != 1).astype(np.float32)   # a third idle
    return stacked, xb, yb, active


def _fmaf(a, b, c):
    """CUDA's fmaf on f32 arrays: a * b + c rounded once.  The product is
    exact in f64; the sum is rounded to odd there (TwoSum gives its error),
    and rounding that to the nearest f32 is the exact sum's rounding."""
    a, b, c = (np.asarray(v, F32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)            # p + c == s + err exactly
    inexact = err != 0
    trunc = np.where(inexact & (np.signbit(err) != np.signbit(s)),
                     np.nextafter(s, 0.0), s)
    odd = np.ascontiguousarray(trunc).view(np.int64) | inexact
    return odd.view(np.float64).astype(F32)


def _dot4(a, b):
    """(n, m) x (o, m) -> (n, o) as the kernel's dot sums each output: four
    interleaved fmaf chains over m, combined (0 + 1) + (2 + 3), then the
    tail's fmaf in order."""
    m = a.shape[1]
    acc = [np.zeros((a.shape[0], b.shape[0]), F32) for _ in range(4)]
    j = 0
    while j + 4 <= m:
        for e in range(4):
            acc[e] = _fmaf(a[:, None, j + e], b[None, :, j + e], acc[e])
        j += 4
    out = (acc[0] + acc[1]) + (acc[2] + acc[3])
    for q in range(j, m):
        out = _fmaf(a[:, None, q], b[None, :, q], out)
    return out


def _warp_sum(v):
    """(n, 32) lanes -> (n,): the shuffle butterfly, xor 16, 8, 4, 2, 1."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    return v[:, 0]


def _split(r, n, c):
    return r * n // c, (r + 1) * n // c


def _grad_jobs(lo, hi, n):
    """The (row, first column) writes of one CTA's gradient jobs on weight
    rows [lo, hi) of an n-column weight, and whether it owns the bias."""
    nc = ((n + 3) & ~3) // 4
    rows, cols, bias = [], [], False
    for jj in range((hi - lo + 1) // 2 * nc):
        pi = jj // nc
        c = 4 * (jj - pi * nc)
        q0 = lo + 2 * pi
        for q in ((q0, q0 + 1) if q0 + 1 < hi else (q0,)):
            rows.append(q)
            cols.append(c)
        bias |= q0 == 0
    return rows, cols, bias


def _emulate_cluster(src, xs, ys, a_row, lr, widths, with_losses, C):
    """One row's cluster of C CTAs: the new row (P,) and the row's loss."""
    d, h, g, n_cls = widths
    steps, B = ys.shape
    shapes = {"b1": (h,), "b2": (g,), "b3": (n_cls,), "w1": (d, h),
              "w2": (h, g), "w3": (g, n_cls)}
    offs, o = {}, 0
    for n in T_FSGD.LEAVES:
        offs[n] = o
        o += int(np.prod(shapes[n]))
    leaf = {n: src[offs[n]:offs[n] + int(np.prod(shapes[n]))]
            .reshape(shapes[n]) for n in T_FSGD.LEAVES}
    sm = [{n: v.copy() for n, v in leaf.items()} for _ in range(C)]
    act = [{"h1": np.zeros((B, h), F32), "h2": np.zeros((B, g), F32),
            "dz": np.zeros((B, n_cls), F32), "dh2": np.zeros((B, g), F32),
            "dh1": np.zeros((B, h), F32)} for _ in range(C)]
    nll0 = np.zeros(B, F32)                     # rank 0's per-sample NLL
    out = np.full(src.shape, np.nan, F32)
    out_writes = np.zeros(src.shape, int)
    s_lr = F32(a_row) * F32(lr)
    loss_sum = F32(0)

    def push(name, rows, cols, vals):
        for r in range(C):
            act[r][name][rows, cols] = vals

    for t in range(steps):
        x, y = xs[t], ys[t]
        last = t + 1 == steps
        for r in range(C):                      # h1, then h2, of r's samples
            s0, s1 = _split(r, B, C)
            acc = np.zeros((s1 - s0, h), F32)
            for q in range(d):
                acc = _fmaf(x[s0:s1, q, None], sm[r]["w1"][q], acc)
            push("h1", slice(s0, s1), slice(None),
                 np.maximum(acc + sm[r]["b1"], F32(0)))
        for r in range(C):
            s0, s1 = _split(r, B, C)
            acc = np.zeros((s1 - s0, g), F32)
            for q in range(h):
                acc = _fmaf(act[r]["h1"][s0:s1, q, None], sm[r]["w2"][q], acc)
            push("h2", slice(s0, s1), slice(None),
                 np.maximum(acc + sm[r]["b2"], F32(0)))
        for r in range(C):                      # a warp per sample
            s0, s1 = _split(r, B, C)
            hs = act[r]["h2"][s0:s1]
            lg = _dot4(hs, sm[r]["w3"].T) + sm[r]["b3"]
            m = lg.max(-1, keepdims=True)
            lanes = np.zeros((s1 - s0, 32), F32)
            for j in range(n_cls):              # lane j % 32, j in order
                lanes[:, j % 32] += np.exp(lg[:, j] - m[:, 0])
            tot = _warp_sum(lanes)[:, None]
            yl = y[s0:s1]
            onehot = (yl[:, None] == np.arange(n_cls)).astype(F32)
            if with_losses:
                logp = (lg - m) - np.log(tot)
                dz = (np.exp(logp) - onehot) / F32(B)
                nll0[s0:s1] = -(logp * onehot).sum(-1)   # one nonzero term
            else:
                dz = (np.exp(lg - m) / tot - onehot) / F32(B)
            push("dz", slice(s0, s1), slice(None), dz)
            push("dh2", slice(s0, s1), slice(None),
                 np.where(hs > 0, _dot4(dz, sm[r]["w3"]), F32(0)))
        nq = (h + 1) // 2
        pairs = [q for q0 in range(nq) for q in (q0, q0 + nq) if q < h]
        assert sorted(pairs) == list(range(h))  # dh1's pairs cover h once
        for r in range(C):
            s0, s1 = _split(r, B, C)
            dh1 = _dot4(act[r]["dh2"][s0:s1], sm[r]["w2"])
            push("dh1", slice(s0, s1), slice(None),
                 np.where(act[r]["h1"][s0:s1] > 0, dh1, F32(0)))
        # cluster barrier: every CTA holds the whole batch's activations
        if with_losses:
            tot = F32(0)
            for b in range(B):
                tot = tot + nll0[b]
            loss_sum = loss_sum + tot / F32(B)
        writes = {n: np.zeros(shapes[n], int) for n in T_FSGD.LEAVES}
        new = []
        for r in range(C):
            for wn, bn, a, dl, rows in (("w2", "b2", act[r]["h1"],
                                         act[r]["dh2"], h),
                                        ("w1", "b1", x, act[r]["dh1"], d),
                                        ("w3", "b3", act[r]["h2"],
                                         act[r]["dz"], g)):
                lo, hi = _split(r, rows, C)
                n = dl.shape[1]
                gw = np.zeros((rows, n), F32)
                gb = np.zeros(n, F32)
                for b in range(B):              # the batch in sample order
                    gw[lo:hi] = _fmaf(a[b, lo:hi, None], dl[b], gw[lo:hi])
                    gb = gb + dl[b]
                nw = _fmaf(-s_lr, gw, sm[r][wn])
                nb = _fmaf(-s_lr, gb, sm[r][bn])
                jr, jc, bias = _grad_jobs(lo, hi, n)
                for q, c in zip(jr, jc):
                    cols = slice(c, min(c + 4, n))
                    writes[wn][q, cols] += 1
                    new.append((wn, (q, cols), nw[q, cols]))
                for c in (range(0, n, 4) if bias else ()):
                    cols = slice(c, min(c + 4, n))
                    writes[bn][cols] += 1
                    new.append((bn, cols, nb[cols]))
        for n in T_FSGD.LEAVES:                 # each parameter, one writer
            assert (writes[n] == 1).all(), (n, t, C)
        for name, at, vals in new:
            if last:
                flat = np.arange(offs[name], offs[name]
                                 + int(np.prod(shapes[name])))
                idx = flat.reshape(shapes[name])[at]
                out[idx] = vals
                out_writes[idx] += 1
            else:
                for r in range(C):
                    sm[r][name][at] = vals
        for r in range(1, C):                   # every CTA's copy agrees
            assert all(np.array_equal(sm[r][n], sm[0][n], equal_nan=True)
                       for n in T_FSGD.LEAVES)
    assert (out_writes == 1).all()              # the row written once
    loss = loss_sum / F32(steps) if with_losses else F32(0)
    return out, loss


def _emulate_fused_sgd(buf, xb, yb, active, spec, lr, with_losses, C):
    """The kernel's grid: block i is CTA i % C of row i // C's cluster, and
    reads its row, minibatches and labels at the kernel's flat offsets."""
    k, P = buf.shape
    steps, B, d = xb.shape[1:]
    shp = dict(zip(spec.keys, spec.shapes))
    widths = (d, shp["w2"][0], shp["w3"][0], shp["w3"][1])
    flat_buf, flat_x, flat_y = (np.ascontiguousarray(v).reshape(-1)
                                for v in (buf, xb, yb))
    out = np.empty(k * P, F32)
    loss = np.empty(k, F32)
    for first in range(0, k * C, C):
        row = first // C
        at = row * steps
        out[row * P:(row + 1) * P], loss[row] = _emulate_cluster(
            flat_buf[row * P:(row + 1) * P],
            flat_x[at * B * d:(at + steps) * B * d].reshape(steps, B, d),
            flat_y[at * B:(at + steps) * B].reshape(steps, B),
            active[row], lr, widths, with_losses, C)
    return out.reshape(k, P), loss


def _exact_f32(v: Fraction) -> np.float32:
    """The f32 nearest v, ties to even."""
    x = np.float32(float(v))
    cands = [np.nextafter(x, F32(-np.inf)), x, np.nextafter(x, F32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - v),
                                     int(np.asarray(c).view(np.int32)) & 1))


def test_fmaf_replay_rounds_once():
    """``_fmaf`` against exact rational arithmetic: random operands, exact
    cancellations (a b - fl(a b)) and f32 midpoints nudged by a tiny c, where
    rounding twice would land on the even neighbour."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=300).astype(F32)
    b = (rng.normal(size=300) * 10.0 ** rng.integers(-8, 8, 300)).astype(F32)
    c = (rng.normal(size=300) * 10.0 ** rng.integers(-12, 8, 300)).astype(F32)
    c[:100] = -(a[:100] * b[:100])              # the product's own rounding
    mid_a = np.full(40, 4097, F32)              # 4097^2 = 2^24 + 8193: a
    mid_b = np.full(40, 4097, F32)              # f32 midpoint, exact in f64
    mid_c = (np.where(np.arange(40) % 2, 1, -1)
             * 2.0 ** -np.arange(20, 60)).astype(F32)
    a, b, c = (np.concatenate(v) for v in ((a, mid_a), (b, mid_b),
                                          (c, mid_c)))
    got = _fmaf(a, b, c)
    for i in range(len(a)):
        want = _exact_f32(Fraction(float(a[i])) * Fraction(float(b[i]))
                          + Fraction(float(c[i])))
        assert got[i] == want, (a[i], b[i], c[i], got[i], want)
    assert not np.array_equal(got[-40:], a[-40:] * b[-40:] + c[-40:])


@pytest.mark.parametrize("batch", [8, 30])
@pytest.mark.parametrize("with_losses", [True, False])
def test_fused_sgd_cluster_split_matches_plain_and_pallas(batch, with_losses):
    """C in {1, 2, 4} (30 is not a multiple of 4): within 1e-5 of the plain
    version and of the Pallas kernel, and the same bits at every C."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.dfl import flat_state as R_FS
    from repro.kernels import fused_sgd as R_FSGD
    stacked, xb, yb, active = _mlp_inputs(batch, 3, 2, batch)
    buf, spec = T_FS.from_reference(stacked, "cpu")
    x, y, a = (torch.from_numpy(v) for v in (xb, yb, active))
    lr = 0.1
    plain, p_loss = T_FSGD.local_sgd_flat_fused(buf, x, y, a, spec, lr,
                                                with_losses=with_losses)
    with jax.default_device(jax.devices("cpu")[0]):   # full f32 products
        r_buf, r_spec = R_FS.flatten_stacked(stacked)
        pallas, j_loss = R_FSGD.fused_sgd(
            r_buf, jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(active),
            r_spec, lr, with_losses=with_losses, interpret=True)
    first = None
    for C in (1, 2, 4):
        out, loss = _emulate_fused_sgd(buf.numpy(), xb, yb, active, spec, lr,
                                       with_losses, C)
        for ref, ref_loss in ((plain.numpy(), p_loss.numpy()),
                              (np.asarray(pallas), np.asarray(j_loss))):
            np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
            np.testing.assert_allclose(loss, ref_loss, atol=1e-5, rtol=0)
        idle = active == 0
        assert np.array_equal(out[idle], buf.numpy()[idle])  # same bits
        if first is None:
            first = (out, loss)
        else:
            assert np.array_equal(out, first[0])
            assert np.array_equal(loss, first[1])


def test_fused_sgd_emulated_row_alone_equals_row_among_five():
    stacked, xb, yb, active = _mlp_inputs(7, 5, 2, 12)
    buf, spec = T_FS.from_reference(stacked, "cpu")
    buf = buf.numpy()
    C = T_FSGD.cluster_size(12)
    out, loss = _emulate_fused_sgd(buf, xb, yb, active, spec, 0.1, True, C)
    for i in (0, 3):
        one, one_loss = _emulate_fused_sgd(buf[i:i + 1], xb[i:i + 1],
                                           yb[i:i + 1], active[i:i + 1],
                                           spec, 0.1, True, C)
        assert np.array_equal(one[0], out[i]) and one_loss[0] == loss[i]


def test_fused_sgd_cluster_rule_and_size_refusals():
    assert [T_FSGD.cluster_size(b) for b in (1, 3, 4, 30, 32)] == [1, 3, 4,
                                                                   4, 4]
    spec = T_FS.spec_of({n: torch.from_numpy(v) for n, v in
                         _mlp_inputs(0, 1, 1, 1)[0].items()})
    for steps, batch in ((0, 32), (2, 0)):
        with pytest.raises(ValueError, match="steps >= 1 and batch >= 1"):
            T_FSGD.check_sizes(spec, steps, batch)


def _cuda_sgd(seed, k, steps, batch, widths=(32, 64, 64, 10)):
    d, h, g, c = widths
    stacked, xb, yb, active = _mlp_inputs(seed, k, steps, batch, d, h, g, c)
    buf, spec = T_FS.from_reference(stacked, "cuda")
    x, y, a = (torch.from_numpy(v).cuda() for v in (xb, yb, active))
    return buf, x, y, a, spec


@pytest.mark.cuda
def test_cuda_fused_sgd_row_bits_follow_the_row_alone():
    """On the card: a row's bits alone and among k = 100 rows, on a second
    launch, at batch 30 (not a multiple of the cluster), at widths other
    than the default and at 50 steps; within 1e-4 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused_sgd kernel has no CPU mode "
                    "(its order of operations is replayed above)")
    torch.backends.cuda.matmul.allow_tf32 = False
    before = T_FSGD.launches
    n = 0
    for widths, batch, steps in (((32, 64, 64, 10), 32, 2),
                                 ((32, 64, 64, 10), 30, 2),
                                 ((20, 48, 36, 7), 32, 2),
                                 ((32, 128, 128, 10), 32, 2),
                                 ((32, 64, 64, 10), 32, 50)):
        for with_losses in (False, True):
            buf, x, y, a, spec = _cuda_sgd(batch, 100, steps, batch, widths)
            out, loss = T_FSGD.fused_sgd(buf, x, y, a, spec, 0.05,
                                         with_losses)
            again, again_loss = T_FSGD.fused_sgd(buf, x, y, a, spec, 0.05,
                                                 with_losses)
            ref, ref_loss = T_FSGD.local_sgd_flat_fused(buf, x, y, a, spec,
                                                        0.05, with_losses)
            n += 2
            torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
            torch.testing.assert_close(loss, ref_loss, atol=1e-4, rtol=0)
            assert torch.equal(out, again) and torch.equal(loss, again_loss)
            assert torch.equal(out[a == 0], buf[a == 0])
            for i in (0, 37, 99):
                one, one_loss = T_FSGD.fused_sgd(buf[i:i + 1], x[i:i + 1],
                                                 y[i:i + 1], a[i:i + 1],
                                                 spec, 0.05, with_losses)
                n += 1
                assert torch.equal(one[0], out[i]), (widths, batch, i)
                assert torch.equal(one_loss[0], loss[i])
    assert T_FSGD.launches == before + n


@pytest.mark.cuda
def test_cuda_fused_sgd_shared_memory_limit():
    """The C entry's size: 72,624 B at the simulation default at any number
    of steps; hidden 164 fits at batch 32, 165 raises in the wrapper, and a
    simulation on the card refuses it while it sets up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the size comes from the kernel's "
                    "library")
    from repro_torch.core.protocol import DySTop
    from repro_torch.dfl.simulator import SimConfig, run_simulation
    assert T_FSGD.smem_bytes(32, 32, 64, 64, 10) == 72624
    assert T_FSGD.smem_bytes(32, 32, 164, 164, 10) <= T_FSGD.SMEM_LIMIT
    assert T_FSGD.smem_bytes(32, 32, 165, 165, 10) > T_FSGD.SMEM_LIMIT
    buf, x, y, a, spec = _cuda_sgd(0, 4, 2, 32, (32, 165, 165, 10))
    with pytest.raises(ValueError, match="shared memory"):
        T_FSGD.fused_sgd(buf, x, y, a, spec, 0.05)
    cfg = SimConfig(n_workers=4, n_rounds=2, hidden=165, n_samples=400)
    launched = T_FSGD.launches
    with pytest.raises(ValueError, match="shared memory"):
        run_simulation(DySTop(V=10.0, t_thre=20, max_neighbors=3), cfg)
    assert T_FSGD.launches == launched


# --------------------------------------------------------------------------- #
# moe_router (kernel row 6)
# --------------------------------------------------------------------------- #

def _segment(e):
    return 8 if e <= 8 else 16 if e <= 16 else 32


def _emulate_router(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's top-k on (T, E) f32 probabilities: lane l of a row's
    segment holds experts l, l + SEG, ...; it keeps its best KT = min(k,
    NPL) by the insertion the kernel runs (a key passes only strictly
    smaller keys, candidates in index order); each round the largest head
    key wins, the lowest index among equal keys, and that lane pops."""
    t, e = probs.shape
    seg = _segment(e)
    npl = -(-e // seg)
    kk = next(v for v in (2, 4, 8, 16) if k <= v)
    kt = min(npl, kk)
    keys = probs.contiguous().view(torch.int32).long() + 1   # bits + 1
    ids = torch.empty((t, k), dtype=torch.int32)
    for row in range(t):
        lists = []
        for lane in range(seg):
            tk, ti = [0] * kt, [2 ** 31 - 1] * kt
            for j in range(npl):
                ex = lane + seg * j
                key = int(keys[row, ex]) if ex < e else 0
                for p in range(min(j, kt - 1), 0, -1):
                    up, here = tk[p - 1] < key, tk[p] < key
                    ti[p] = ti[p - 1] if up else (ex if here else ti[p])
                    tk[p] = tk[p - 1] if up else (key if here else tk[p])
                if tk[0] < key:
                    tk[0], ti[0] = key, ex
            lists.append((tk, ti))
        for r in range(k):
            best = max(tk[0] for tk, _ in lists)
            best_i = min(ti[0] for tk, ti in lists if tk[0] == best)
            for tk, ti in lists:
                if ti[0] == best_i:
                    del tk[0], ti[0]
                    tk.append(0)
                    ti.append(2 ** 31 - 1)
            ids[row, r] = best_i
    return ids


def _plain_probs(x: torch.Tensor) -> torch.Tensor:
    """moe_router_plain's probabilities, op for op."""
    x = x - x.max(dim=-1, keepdim=True).values
    p = torch.exp(x)
    return p / p.sum(dim=-1, keepdim=True)


def _rounding_tie_row(e: int, seed: int) -> np.ndarray:
    """A row of logits with two distinct entries whose probabilities round
    to the same f32 while their exp values differ, the larger logit at the
    higher index (picking on logits or on exp would choose it first)."""
    rng = np.random.default_rng(seed)
    base = (rng.normal(size=e) * 0.5).astype(np.float32)
    base[0] = 2.5           # the leader; the pair sits within 1 of it, where
    a = np.linspace(1.5, 2.4, 4001, dtype=np.float32)   # exp moves <= 1 ulp
    rows = np.repeat(base[None], len(a), 0)
    rows[:, 3] = a
    rows[:, e - 2] = np.nextafter(a, np.float32(np.inf))
    x = torch.from_numpy(rows)
    ex = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    p = _plain_probs(x)
    hit = ((ex[:, 3] != ex[:, e - 2]) & (p[:, 3] == p[:, e - 2])).nonzero()
    if len(hit):
        return rows[int(hit[0])]
    raise AssertionError("no rounding tie found")


def _tie_rows(t, e, seed):
    """Rows of equal logits, of repeated maxima, of +-1e4 (the rest
    underflow to probability 0), of rising distinct logits that all
    underflow to 0 beside one leader, and with a division-rounding tie."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(t, e)) * 3).astype(np.float32)
    x[0] = 1.0
    x[1] = -5.0
    x[1, [2, e - 1]] = 2.0
    x[2, : e // 2] = 1e4
    x[2, e // 2:] = -1e4
    x[3] = -200.0 - 0.5 * (e - np.arange(e))     # distinct, all prob 0 ...
    x[3, e // 3] = 50.0                          # ... beside one leader
    x[4] = _rounding_tie_row(e, seed)
    return x


@pytest.mark.parametrize("t, e, k", [(6, 8, 2), (6, 16, 4), (6, 24, 3),
                                     (6, 64, 8), (6, 384, 8), (5, 512, 16)])
def test_moe_router_sorted_merge_matches_plain_ids(t, e, k):
    x = torch.from_numpy(_tie_rows(t, e, t * e + k))
    p = _plain_probs(x)
    # the constructed cases are what they claim to be
    assert (p[3] == 0).sum() == e - 1 and p[4, 3] == p[4, e - 2]
    assert x[4, 3] != x[4, e - 2]
    _, ids = T_MR.moe_router_plain(x, k)
    assert torch.equal(_emulate_router(p, k), ids)


@pytest.mark.cuda
def test_cuda_moe_router_kimi_shape_and_ties():
    """On the card: kimi's (4096, 384, 8) and grok's E = 8 with tie rows
    (equal logits, repeated maxima, +-1e4, distinct logits all underflowing
    to probability 0): ids equal to the plain version's, gates within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the moe_router kernel has no CPU "
                    "mode (its merge is emulated above)")
    before = T_MR.launches
    cases = [(4096, 384, 8), (300, 8, 2), (64, 16, 4), (64, 512, 16)]
    for t, e, k in cases:
        x = _tie_rows(t, e, t + e)
        x[4] = x[3]          # exact ties only: the card's sums round elsewhere
        x = torch.from_numpy(x).cuda()
        gates, ids = T_MR.moe_router(x, k)
        p_gates, p_ids = T_MR.moe_router_plain(x, k)
        torch.cuda.synchronize()
        assert torch.equal(ids, p_ids), (t, e, k)
        torch.testing.assert_close(gates, p_gates, atol=1e-6, rtol=0)
        assert bool(torch.isfinite(gates).all())
        assert math.isclose(float(gates.sum(1).min()), 1.0, rel_tol=1e-5)
    assert T_MR.launches == before + len(cases)

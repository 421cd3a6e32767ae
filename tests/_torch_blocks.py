"""The block harness: every block of a smoke config, run by the JAX package
as it compiles it and by the port on the same input bits.

The reference is the JAX package compiled by XLA under ``jax.jit`` with
default flags on its CPU backend, attention through its Pallas flash
kernel in interpret mode (``KernelConfig(backend="pallas")``), the MoE
router through its Pallas router.  Its own residual stream is built layer
by layer from its embedding of seeded tokens (paligemma: seeded prefix
embeddings in front; seamless: seeded frames into the encoder); each
layer's input is handed to the reference's block and to the port's
(``transformer.apply_layer``; seamless: ``encdec._encoder_layer`` and
``_decoder_layer``).  The reference's decoder-only block is ``apply_layer``
line for line (``Pair._layer``) with one freedom the model takes: inside
one compiled stretch of layers XLA hands a layer's last residual sum on to
the next layer's ``ln1`` in f32, unrounded, and only a scan's carry is
rounded (``Pair.layers``' ``hand_on``).  Seamless's layers are the bodies
of ``encdec.encode``'s and ``encdec.forward``'s scans, line for line.

Beside each layer, sub-blocks get the reference's own inputs: the mixer
(attention, RG-LRU or SSM) on the reference's ``ln1`` output and the FFN
(MLP or MoE) on its ``ln2`` output; in bf16 also the mixer's and the
MoE's own pieces: attention's projections with rope, its core (flash, the
prefix-LM's einsum path, cross-attention) and its out-projection; the
RG-LRU's conv, gates, scan, gelu branch and out-projection; the MoE's
router, gates, routed experts with the combine, and shared experts.  The
embedding, the head (``final_norm`` then ``lm_logits`` with its softcap)
and the loss (``softmax_cross_entropy`` on the reference's logits) are
blocks too.

A block's bf16 reading is two shares of its outputs: those that differ at
all, and those more than one bf16 ulp apart, the ulp taken at the larger of
|ref| and rms(ref) / 64 (``shares``).  The chain check holds the jitted
blocks, chained, against the reference's own ``forward`` / ``encode``
under ``lax.scan``, so that a standalone compile is known to stand for the
block as the model runs it.

The backward (``read_grad``): each block, and the layer cut in two at the
residual sum ``ln2`` reads (``half:*``), is fed the reference's own input
and a numpy cotangent seeded by the token seed and the block's name
(``pullback``), pulled back through the reference's block under
``jax.jit(jax.vjp(...))`` and through the port's with
``torch.autograd.grad``; a Block per gradient leaf.  The whole model's
``compute_loss`` gradients are blocks too (kind "model:d<leaf>"), and
the chain holds the reference's block pullbacks, chained from the loss
down with the model's own cotangents, against its
``jax.value_and_grad``.

Decode (``read_decode``): the reference prefills ``PROMPT`` seeded tokens
and the port takes its cache over; one more step is read block by block
(each layer with the cache rows it writes, each layer as the serving
engine's vmapped one-row step, each mixer's step, the head), and the
chain holds the jitted layers, chained, against the reference's own
``decode_step``.

``PYTHONPATH=src python tests/_torch_blocks.py [arch ...]`` prints every
block's reading over ``SEEDS`` in both dtypes, forward, backward ("grad")
and decode, and each block kind's largest; with ``--bounds`` the bounds
in the test files' form (``tests/test_torch_blocks*.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import sys
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

B = 2
SEEDS = (5, 6, 7)
# text positions per config: past gemma2's and recurrentgemma's smoke
# window of 64; a multiple of mamba2's chunk; paligemma's 24 follow its 16
# prefix positions; seamless's 32 tokens meet frames_for(32) = 8 frames
SEQ = {"gemma2-2b": 96, "recurrentgemma-2b": 96, "paligemma-3b": 24,
       "seamless-m4t-medium": 32}
DTYPES = ("bfloat16", "float32")
DENSE = ("smollm-135m", "stablelm-1.6b", "gemma2-2b")  # run sharded


class Block(NamedTuple):
    name: str           # where: "embed", "L1", "L1.mixer", "dec0.cross", ...
    kind: str           # what: "embed", "layer:attn", "attn:core:flash", ...
    got: np.ndarray     # the port's output, f32
    want: np.ndarray    # the reference's, f32
    bf16: bool = False  # a gradient of a bf16 leaf (``pullback``)


class Reading(NamedTuple):
    blocks: List[Block]
    scalars: Dict[str, tuple]      # name -> (port, reference)
    chain: Dict[str, tuple]        # name -> (chained blocks, the model's)


def shares(got: np.ndarray, want: np.ndarray):
    """(share of outputs that differ, share more than one bf16 ulp apart):
    ulps at the larger of |want| and rms(want) / 64, so that outputs near
    zero are judged on the block's own scale."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    rms = float(np.sqrt(np.mean(np.square(want.astype(np.float64)))))
    mag = np.maximum(np.abs(want), rms / 64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-38))) - 7)
    return (float(np.mean(got != want)),
            float(np.mean(np.abs(got.astype(np.float64) - want) > ulp)))


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over rms(want)."""
    want = np.asarray(want, np.float64)
    rms = float(np.sqrt(np.mean(np.square(want))))
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(rms, 1e-30))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype("float32"))


def _t(a) -> torch.Tensor:
    from repro_torch.dfl import flat_state as T_FS
    return T_FS.tensor_from_reference(np.asarray(a))


def _paths(tree):
    import jax
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             np.asarray(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


class Pair:
    """One smoke config in both packages: the reference's init (key 0)
    and the same bits as the port's tree, and the reference's blocks, each
    jitted once (``Pair.of`` caches a pair per config and dtype)."""

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def of(arch: str, dtype: str) -> "Pair":
        return Pair(arch, dtype)

    def __init__(self, arch: str, dtype: str):
        import jax
        import jax.numpy as jnp
        from repro.kernels.config import KernelConfig
        from repro.models import encdec as R_E
        from repro.models import layers as R_L
        from repro.models import registry as R_R
        from repro.models import transformer as R_T
        from repro_torch.dfl import flat_state as T_FS
        from repro_torch.models import registry as T_R
        self.arch, self.dtype = arch, dtype
        self.r_cfg = cfg = dataclasses.replace(
            R_R.get_smoke_config(arch), dtype=dtype,
            kernels=KernelConfig(backend="pallas"))
        self.t_cfg = dataclasses.replace(T_R.get_smoke_config(arch),
                                         dtype=dtype)
        self.encdec = R_R.is_encdec(cfg)
        self.prefix_len = cfg.n_prefix_tokens if R_R.has_prefix(cfg) else 0
        self.seq = SEQ.get(arch, 64)
        with jax.default_device(jax.devices("cpu")[0]):
            self.params, _ = R_R.init_params(cfg, jax.random.PRNGKey(0))
        self.tparams = T_FS.params_from_reference(_paths(self.params),
                                                  "cpu")
        eps, dt = cfg.norm_eps, jnp.dtype(dtype)
        # a norm reads an f32 input (a sum handed on) as it is and rounds
        # its output to the activation dtype, as inside the model
        self.norm = jax.jit(lambda x, s: R_L.rms_norm(x, s, eps).astype(dt))
        self.add_norm = jax.jit(lambda x, y, s: R_L.rms_norm(x + y, s, eps))
        self.head = jax.jit(lambda t, s, x: R_L.lm_logits(
            cfg, t, R_L.rms_norm(x, s, eps).astype(dt)))
        self.loss = jax.jit(lambda lg, lab: R_L.softmax_cross_entropy(
            lg, lab, jnp.ones(lab.shape, jnp.float32)))
        self.embed = jax.jit(self._embed)
        self.mixer = jax.jit(self._mixer, static_argnames="kind")
        self.ffn = jax.jit(self._ffn)
        self.attn_parts = jax.jit(self._attn_parts,
                                  static_argnames=("kind", "causal"))
        self.rglru_parts = jax.jit(self._rglru_parts)
        self.moe_parts = jax.jit(self._moe_parts)
        self.vjp = jax.jit(self._vjp, static_argnames=("fn", "static"))
        self.d_mixer = jax.jit(self._d_mixer, static_argnames="kind")
        self.d_layer = jax.jit(self._d_layer,
                               static_argnames=("kind", "hand_on"))
        self.d_rows = jax.jit(self._d_rows,
                              static_argnames=("kind", "hand_on"))
        self.d_self = jax.jit(self._d_self)
        self.d_cross = jax.jit(self._d_cross)
        self.d_dec_layer = jax.jit(self._d_dec_layer)
        if self.encdec:
            def prefill(p, c, f, tok):
                def step(cc, t):
                    return R_E.decode_step(cfg, p, cc, t[:, None])[1], None
                c = R_E.fill_cross_cache(cfg, p, c, f)
                return jax.lax.scan(step, c, jnp.moveaxis(tok, 1, 0))[0]
            self.prefill = jax.jit(prefill)
            self.decode_step = jax.jit(lambda p, c, tok: R_E.decode_step(
                cfg, p, c, tok))
        else:
            self.prefill = jax.jit(lambda p, c, tok: R_T.prefill_cache(
                cfg, p, c, tok)[1])
            self.decode_step = jax.jit(lambda p, c, tok: R_T.decode_step(
                cfg, p, c, tok))
        self.model_grad = jax.jit(jax.value_and_grad(
            lambda p, b: R_R.compute_loss(cfg, p, b)[0]))
        if self.encdec:
            self.enc_layer = jax.jit(self._enc_layer)
            self.dec_layer = jax.jit(self._dec_layer)
            self.dec_parts = jax.jit(self._dec_parts)
            self.encode = jax.jit(lambda p, f: R_E.encode(cfg, p, f))
            self.forward = jax.jit(lambda p, tok, f: R_E.forward(
                cfg, p, tok, f)[0])
        else:
            pl = self.prefix_len
            self.apply_layer = jax.jit(
                lambda p, x, pos, kind: R_T.apply_layer(cfg, p, kind, x, pos,
                                                        pl),
                static_argnames="kind")
            self.layer = jax.jit(self._layer,
                                 static_argnames=("kind", "hand_on"))
            self.ffn_in = jax.jit(self._ffn_in, static_argnames="kind")
            self.forward = jax.jit(lambda p, tok, pre: R_T.forward(
                cfg, p, tok, prefix_embeds=pre)[0])

    # ------------------------------------------------------------------ #
    # the reference's blocks (written from its public ops)
    # ------------------------------------------------------------------ #

    def _embed(self, table, tok, pre):
        import jax.numpy as jnp
        dt = jnp.dtype(self.r_cfg.dtype)
        x = table[tok].astype(dt)
        x = x * jnp.asarray(self.r_cfg.d_model ** 0.5, dt)
        if pre is not None:
            x = jnp.concatenate([pre.astype(dt), x], axis=1)
        return x

    def spec(self, kind, causal=True):
        """The reference's attention spec of a layer kind (an enc-dec
        stack's: causal or not, nothing else)."""
        from repro.models import layers as R_L
        from repro.models import transformer as R_T
        if self.encdec:
            return R_L.AttnSpec(causal=causal)
        return R_T._attn_spec(self.r_cfg, kind, self.prefix_len)

    def _mixer(self, p, h, pos, kind):
        """The layer's mixer on its ``ln1`` output (before any post-norm);
        kind "enc" is the enc-dec encoder's non-causal attention."""
        from repro.models import layers as R_L
        from repro.models import rglru as R_RG
        from repro.models import ssm as R_S
        if kind == "rglru":
            return R_RG.rglru_forward(self.r_cfg, p["rglru"], h)
        if kind == "ssm":
            return R_S.ssm_forward(self.r_cfg, p["ssm"], h)
        return R_L.multihead_attention(
            self.r_cfg, p["attn"], h, self.spec(kind, causal=kind != "enc"),
            pos)[0]

    def _ffn_in(self, p, x, xn, pos, kind):
        """The FFN's input inside a decoder-only layer: ``ln2`` of the
        residual after the mixer (and its post-norm)."""
        from repro.models import layers as R_L
        cfg, eps = self.r_cfg, self.r_cfg.norm_eps
        y = self._mixer(p, R_L.rms_norm(xn, p["ln1"], eps).astype(x.dtype),
                        pos, kind)
        if cfg.post_norm:
            y = R_L.rms_norm(y, p["ln1_post"], eps)
        return R_L.rms_norm(x + y, p["ln2"], eps)

    def _ffn(self, p, h):
        """The MLP, or the MoE FFN with its aux term."""
        import jax.numpy as jnp
        from repro.models import layers as R_L
        from repro.models import moe as R_M
        if "moe" in p:
            return R_M.moe_ffn(self.r_cfg, p["moe"], h)
        return R_L.mlp(self.r_cfg, p["mlp"], h), jnp.zeros((), jnp.float32)

    def _layer(self, p, x, xn, pos, kind, hand_on):
        """``transformer.apply_layer``'s lines, but ``ln1`` reads ``xn``:
        x itself, or inside a scanned group the f32 sum that the layer
        before hands on (XLA drops that add's rounding where the next norm
        upcasts it; the residual is x, rounded).  With ``hand_on`` the
        last residual sum comes back in f32 as the next layer's ``ln1``
        reads it (a jit's f32 output of a bf16 add is its unrounded sum).
        On a bf16 x with ``xn`` = x and no ``hand_on`` this is
        ``apply_layer`` (``test_layer_body_is_apply_layer``)."""
        import jax.numpy as jnp
        from repro.models import layers as R_L
        cfg, eps = self.r_cfg, self.r_cfg.norm_eps
        aux = jnp.zeros((), jnp.float32)
        h = R_L.rms_norm(xn, p["ln1"], eps).astype(x.dtype)
        y = self._mixer(p, h, pos, kind)
        if cfg.post_norm:
            y = R_L.rms_norm(y, p["ln1_post"], eps)
        x = x + y
        if "mlp" in p or "moe" in p:
            h = R_L.rms_norm(x, p["ln2"], eps)
            y, aux = self._ffn(p, h)
            if cfg.post_norm:
                y = R_L.rms_norm(y, p["ln2_post"], eps)
            x = x + y
        return (x.astype(jnp.float32) if hand_on else x), aux

    def _vjp(self, diff, rest, ct, fn, static):
        """(``fn``'s outputs, their pullback of ``ct`` onto ``diff``)."""
        import jax
        f = functools.partial(getattr(self, fn), **dict(static))
        out, pull = jax.vjp(lambda *d: f(*d, *rest), *diff)
        return out, pull(ct)

    def out_shape(self, diff, rest, fn, static):
        import jax
        f = functools.partial(getattr(self, fn), **dict(static))
        return jax.eval_shape(lambda *d: f(*d, *rest), *diff)

    def _g_layer(self, p, xn, pos, kind, hand_on):
        """``_layer`` on its input alone: the residual is its rounding."""
        return self._layer(p, xn.astype(self.r_cfg.dtype), xn, pos,
                           kind=kind, hand_on=hand_on)

    def _g_half_mixer(self, p, xn, pos, kind):
        """A layer's first half as ``_g_layer`` runs it: ``xn``'s rounding
        plus the mixer (and its post-norm) on ``ln1(xn)``, the rounded sum
        that ``ln2`` reads."""
        from repro.models import layers as R_L
        cfg, dt = self.r_cfg, self.r_cfg.dtype
        h = R_L.rms_norm(xn, p["ln1"], cfg.norm_eps).astype(dt)
        y = self._mixer(p, h, pos, kind)
        if cfg.post_norm:
            y = R_L.rms_norm(y, p["ln1_post"], cfg.norm_eps)
        return xn.astype(dt) + y

    def _g_half_ffn(self, p, x, hand_on):
        """A layer's second half on the rounded residual x: x plus the FFN
        (and its post-norm) on ``ln2(x)`` -> (x, aux), handed on in f32
        with ``hand_on``."""
        import jax.numpy as jnp
        from repro.models import layers as R_L
        cfg = self.r_cfg
        y, aux = self._ffn(p, R_L.rms_norm(x, p["ln2"], cfg.norm_eps))
        if cfg.post_norm:
            y = R_L.rms_norm(y, p["ln2_post"], cfg.norm_eps)
        x = x + y
        return (x.astype(jnp.float32) if hand_on else x), aux

    def _g_head(self, table, scale, x):
        from repro.models import layers as R_L
        return R_L.lm_logits(self.r_cfg, table, R_L.rms_norm(
            x, scale, self.r_cfg.norm_eps).astype(self.r_cfg.dtype))

    def _g_loss(self, lg, lab, mask=True):
        import jax.numpy as jnp
        from repro.models import layers as R_L
        return R_L.softmax_cross_entropy(
            lg, lab, jnp.ones(lab.shape, jnp.float32) if mask else None)

    def _g_norm(self, x, scale):
        from repro.models import layers as R_L
        return R_L.rms_norm(x, scale, self.r_cfg.norm_eps)

    def _g_qkv(self, p, h, kv, pos, kind, causal):
        """q, k, v after rope (cross-attention: k and v from kv, no
        rope)."""
        import jax.numpy as jnp
        from repro.models import layers as R_L
        cfg = self.r_cfg
        src = h if kv is None else kv
        q = jnp.einsum("bsd,dhk->bshk", h, p["wq"])
        k = jnp.einsum("bsd,dhk->bshk", src, p["wk"])
        v = jnp.einsum("bsd,dhk->bshk", src, p["wv"])
        if kv is None:
            q = R_L.apply_rope(q, pos, cfg.rope_theta)
            k = R_L.apply_rope(k, pos, cfg.rope_theta)
        return q, k, v

    def _g_out(self, core, wo):
        import jax.numpy as jnp
        return jnp.einsum("bshk,hkd->bsd", core, wo)

    def _attn_parts(self, p, h, pos, kind, causal=True, kv=None):
        """``layers.multihead_attention``'s pieces: (q, k, v after rope,
        the core's output (B, S, H, hd), the out-projection's output)."""
        q, k, v = self._g_qkv(p, h, kv, pos, kind, causal)
        core = self._g_core(q, k, v, kind, causal, kv is not None)
        return q, k, v, core, self._g_out(core, p["wo"])

    def _g_core(self, q, k, v, kind, causal, cross):
        """The attention core on q, k, v: (B, S, H, hd)."""
        import jax
        import jax.numpy as jnp
        from repro.kernels import ops as R_K
        from repro.models import layers as R_L
        cfg = self.r_cfg
        spec = self.spec(kind, causal)
        hd, g = cfg.resolved_head_dim, cfg.q_per_kv
        kv = k if cross else None
        b, s = q.shape[:2]
        qg = q.reshape(b, s, cfg.n_kv_heads, g, hd)
        if kv is None and not spec.prefix_len:
            qh = jnp.swapaxes(q, 1, 2)
            kh = jnp.swapaxes(jnp.repeat(k, g, axis=2), 1, 2)
            vh = jnp.swapaxes(jnp.repeat(v, g, axis=2), 1, 2)
            core = jnp.swapaxes(R_K.flash_attention_diff(
                qh, kh, vh, cfg.kernels, causal=spec.causal,
                window=spec.window, softcap=spec.softcap), 1, 2)
        else:
            sc = jnp.einsum("bsngk,btnk->bnsgt", qg, k).astype(jnp.float32)
            sc = sc * hd ** -0.5
            if spec.softcap is not None:
                sc = jnp.tanh(sc / spec.softcap) * spec.softcap
            if kv is None:
                i = jnp.arange(s, dtype=jnp.int32)
                mask = R_L._attn_mask(i, i, spec)[None, None, :, None, :]
                sc = jnp.where(mask, sc, -1e30)
            pr = jax.nn.softmax(sc, axis=-1).astype(v.dtype)
            core = jnp.einsum("bnsgt,btnk->bsngk", pr, v)
        return core.reshape(b, s, cfg.n_heads, hd)

    def _g_conv(self, p, h):
        """The RG-LRU's input projection and conv, read in f32."""
        import jax.numpy as jnp
        from repro.models import ssm as R_S
        xr, _ = R_S._causal_conv(h @ p["w_rec"], p["conv_w"], p["conv_b"])
        return xr.astype(jnp.float32)

    def _g_gates(self, p, xr):
        from repro.models import rglru as R_RG
        return R_RG._gates(p, xr)

    def _g_scan(self, log_a, b):
        import jax
        import jax.numpy as jnp

        def combine(left, right):
            return left[0] + right[0], jnp.exp(right[0]) * left[1] + right[1]

        return jax.lax.associative_scan(combine, (log_a, b), axis=1)[1]

    def _g_gelu(self, w, h):
        import jax
        import jax.numpy as jnp
        return jax.nn.gelu((h @ w).astype(jnp.float32))

    def _g_rglru_out(self, g, hs, w, dtype):
        return (g * hs).astype(dtype) @ w

    def _rglru_parts(self, p, h):
        """``rglru.rglru_forward``'s pieces: (the conv's output read in
        f32, log_a, the gated input b, the scan's h, the gelu branch, the
        output)."""
        import jax
        import jax.numpy as jnp
        from repro.models import rglru as R_RG
        from repro.models import ssm as R_S
        g = jax.nn.gelu((h @ p["w_gelu"]).astype(jnp.float32))
        xr, _ = R_S._causal_conv(h @ p["w_rec"], p["conv_w"], p["conv_b"])
        log_a, b = R_RG._gates(p, xr)
        hs = self._g_scan(log_a, b)
        y = (g * hs).astype(h.dtype) @ p["w_out"]
        return xr.astype(jnp.float32), log_a, b, hs, g, y

    def _g_router(self, router, h):
        import jax.numpy as jnp
        return h.reshape(-1, h.shape[-1]).astype(jnp.float32) @ router

    def _g_route_gates(self, logits):
        from repro.kernels import ops as R_K
        return R_K.moe_router_diff(logits, self.r_cfg.moe.top_k,
                                   self.r_cfg.kernels)[0]

    def _g_experts(self, p, xt, gates, eids):
        """The routed experts and the top-k combine on given gates and
        ids."""
        import jax
        import jax.numpy as jnp
        from repro.models import moe as R_M
        cfg, m = self.r_cfg, self.r_cfg.moe
        t = xt.shape[0]
        c = R_M.expert_capacity(cfg, t)
        slots, keep = R_M.dispatch_indices(eids, m.n_experts, c)
        tok = jnp.repeat(jnp.arange(t, dtype=jnp.int32), m.top_k)
        buf = jnp.zeros((m.n_experts * c + 1, xt.shape[1]), xt.dtype)
        buf = buf.at[slots].set(xt[tok], mode="drop", unique_indices=True)
        ebuf = buf[: m.n_experts * c].reshape(m.n_experts, c, -1)
        act = jax.nn.gelu if cfg.mlp_activation == "gelu" else jax.nn.silu
        hh = act(jnp.einsum("ecd,edf->ecf", ebuf, p["w_gate"])) * jnp.einsum(
            "ecd,edf->ecf", ebuf, p["w_up"])
        out = jnp.einsum("ecf,efd->ecd", hh, p["w_down"])
        out = jnp.concatenate([out.reshape(m.n_experts * c, -1),
                               jnp.zeros((1, xt.shape[1]), out.dtype)])
        w = (gates.reshape(-1) * keep.astype(jnp.float32)).astype(xt.dtype)
        return jnp.sum((out[slots] * w[:, None]).reshape(t, m.top_k, -1),
                       axis=1)

    def _g_shared(self, sp, xt):
        import jax
        act = (jax.nn.gelu if self.r_cfg.mlp_activation == "gelu"
               else jax.nn.silu)
        return (act(xt @ sp["w_gate"]) * (xt @ sp["w_up"])) @ sp["w_down"]

    def _moe_parts(self, p, h):
        """``moe.moe_ffn``'s pieces on (B, S, D): (router logits, gates,
        expert ids, the routed combine, the shared experts' output or
        None)."""
        import jax.numpy as jnp
        from repro.models import moe as R_M
        cfg = self.r_cfg
        xt = h.reshape(-1, h.shape[-1])
        logits = xt.astype(jnp.float32) @ p["router"]
        gates, eids, _ = R_M.route(cfg, p["router"], xt)
        y = self._g_experts(p, xt, gates, eids)
        shared = None
        if cfg.moe.n_shared_experts:
            shared = self._g_shared(p["shared"], xt)
        return logits, gates, eids, y, shared

    def _d_mixer(self, p, cache, h, pos, kind):
        """A layer's decode mixer on its ``ln1`` output -> (y, the layer's
        new cache)."""
        from repro.models import rglru as R_RG
        from repro.models import ssm as R_S
        from repro.models import transformer as R_T
        cfg = self.r_cfg
        if kind == "rglru":
            return R_RG.rglru_decode_step(cfg, p["rglru"], cache, h)
        if kind == "ssm":
            return R_S.ssm_decode_step(cfg, p["ssm"], cache, h)
        return R_T._ring_attention_step(cfg, p["attn"], h, cache, pos,
                                        R_T._attn_spec(cfg, kind, 0))

    def _d_layer(self, p, cache, x, xn, pos, kind, hand_on):
        """``transformer.decode_layer``'s lines, ``ln1`` reading ``xn`` and
        the last sum handed on in f32 with ``hand_on`` (as ``_layer``)."""
        import jax.numpy as jnp
        from repro.models import layers as R_L
        from repro.models import moe as R_M
        cfg, eps = self.r_cfg, self.r_cfg.norm_eps
        h = R_L.rms_norm(xn, p["ln1"], eps).astype(x.dtype)
        y, new_cache = self._d_mixer(p, cache, h, pos, kind)
        if cfg.post_norm:
            y = R_L.rms_norm(y, p["ln1_post"], eps)
        x = x + y
        if "mlp" in p or "moe" in p:
            h = R_L.rms_norm(x, p["ln2"], eps)
            y = (R_M.moe_ffn(cfg, p["moe"], h)[0] if "moe" in p
                 else R_L.mlp(cfg, p["mlp"], h))
            if cfg.post_norm:
                y = R_L.rms_norm(y, p["ln2_post"], eps)
            x = x + y
        return (x.astype(jnp.float32) if hand_on else x), new_cache

    def _d_rows(self, p, cache, x, xn, pos, kind, hand_on):
        """``_d_layer`` vmapped over the batch rows, each row a batch of
        one at its own position (the serving engine's step)."""
        import jax

        def one(c, xr, xnr, pr):
            c = jax.tree.map(lambda leaf: leaf[None], c)
            y, nc = self._d_layer(p, c, xr[None], xnr[None], pr, kind,
                                  hand_on)
            return y[0], jax.tree.map(lambda leaf: leaf[0], nc)
        return jax.vmap(one)(cache, x, xn, pos)

    def _d_self(self, p, cache, h, pos):
        from repro.models import layers as R_L
        from repro.models import transformer as R_T
        return R_T._ring_attention_step(self.r_cfg, p, h, cache, pos,
                                        R_L.AttnSpec(causal=True))

    def _d_cross(self, lp, x, ck, cv):
        from repro.models import encdec as R_E
        return R_E._cross_step(self.r_cfg, lp, x, ck, cv)[0]

    def _d_dec_layer(self, lp, c, x, pos):
        """``encdec.decode_step``'s scanned body, line for line."""
        from repro.models import layers as R_L
        cfg = self.r_cfg
        h = R_L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, nc = self._d_self(lp["attn"], {"k": c["k"], "v": c["v"],
                                          "k_pos": c["k_pos"]}, h, pos)
        x = self._d_cross(lp, x + y, c["ck"], c["cv"])
        h = R_L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + R_L.mlp(cfg, lp["mlp"], h), nc

    def _g_dec_layer(self, lp, xc, enc, positions):
        return self._dec_layer(lp, xc, positions, enc)

    def _g_decoder(self, p, enc, tok):
        """``encdec.forward``'s decoder half on a given encoder output,
        its lines (the scan, the final norm and the head), the loss on
        top: the model's pullback onto ``enc``."""
        import jax
        import jax.numpy as jnp
        from repro.models import layers as R_L
        cfg = self.r_cfg
        b, s = tok.shape
        positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None, :],
                                     (b, s))
        x = self._embed(p["embed"]["table"], tok, None)

        def layer_fn(xc, lp):
            return self._dec_layer(lp, xc, positions, enc), None

        x, _ = jax.lax.scan(layer_fn, x, p["decoder"])
        x = R_L.rms_norm(x, p["final_norm"], cfg.norm_eps)
        return R_L.lm_logits(cfg, p["embed"]["table"], x)

    def _g_cross(self, p, hx, enc, positions):
        from repro.models import layers as R_L
        return R_L.multihead_attention(self.r_cfg, p, hx,
                                       R_L.AttnSpec(causal=False), positions,
                                       kv_x=enc)[0]

    def _enc_layer(self, lp, xc, positions):
        """``encdec.encode``'s scanned body (``layer_fn``), line for line."""
        from repro.models import layers as R_L
        cfg = self.r_cfg
        h = R_L.rms_norm(xc, lp["ln1"], cfg.norm_eps)
        y, _ = R_L.multihead_attention(cfg, lp["attn"], h,
                                       R_L.AttnSpec(causal=False), positions)
        xc = xc + y
        h = R_L.rms_norm(xc, lp["ln2"], cfg.norm_eps)
        return xc + R_L.mlp(cfg, lp["mlp"], h)

    def _dec_layer(self, lp, xc, positions, enc):
        """``encdec.forward``'s scanned body (``layer_fn``), line for
        line."""
        from repro.models import layers as R_L
        cfg = self.r_cfg
        h = R_L.rms_norm(xc, lp["ln1"], cfg.norm_eps)
        y, _ = R_L.multihead_attention(cfg, lp["attn"], h,
                                       R_L.AttnSpec(causal=True), positions)
        xc = xc + y
        h = R_L.rms_norm(xc, lp["ln_x"], cfg.norm_eps)
        y, _ = R_L.multihead_attention(cfg, lp["xattn"], h,
                                       R_L.AttnSpec(causal=False), positions,
                                       kv_x=enc)
        xc = xc + y
        h = R_L.rms_norm(xc, lp["ln2"], cfg.norm_eps)
        return xc + R_L.mlp(cfg, lp["mlp"], h)

    def _dec_parts(self, lp, xc, positions, enc):
        """A decoder layer's inner inputs, as ``_dec_layer`` computes them:
        (``ln_x``'s output, ``ln2``'s output)."""
        from repro.models import layers as R_L
        cfg = self.r_cfg
        h = R_L.rms_norm(xc, lp["ln1"], cfg.norm_eps)
        y, _ = R_L.multihead_attention(cfg, lp["attn"], h,
                                       R_L.AttnSpec(causal=True), positions)
        xc = xc + y
        hx = R_L.rms_norm(xc, lp["ln_x"], cfg.norm_eps)
        y, _ = R_L.multihead_attention(cfg, lp["xattn"], hx,
                                       R_L.AttnSpec(causal=False), positions,
                                       kv_x=enc)
        xc = xc + y
        return hx, R_L.rms_norm(xc, lp["ln2"], cfg.norm_eps)

    # ------------------------------------------------------------------ #
    # the layers, in depth order
    # ------------------------------------------------------------------ #

    def layers(self):
        """[(reference layer params, port layer params, kind, hand_on)] in
        depth order; the reference's stacked ``blocks`` sliced per group,
        as the port's ``transformer._layers`` views them.  ``hand_on``: the
        layer's output is not a scan's carry (only the prelude's last
        layer before the groups and each group's last are), so the model
        hands its f32 sum on to the next norm."""
        import jax
        from repro.models import transformer as R_T
        from repro_torch.models import transformer as T_T
        cfg, p = self.r_cfg, self.params
        n_pre, n_grp, _ = R_T.structure(cfg)
        per = R_T.pattern(cfg)
        ref = [(lp, cfg.layer_kind(i)) for i, lp in enumerate(p["prelude"])]
        for g in range(n_grp):
            gp = jax.tree.map(lambda leaf: leaf[g], p["blocks"])
            ref += [(gp[f"p{j}"], kind) for j, kind in enumerate(per)]
        base = n_pre + n_grp * len(per)
        ref += [(lp, cfg.layer_kind(base + j))
                for j, lp in enumerate(p["coda"])]
        carry = {n_pre - 1} if n_grp else set()
        carry |= {n_pre + (g + 1) * len(per) - 1 for g in range(n_grp)}
        port = T_T._layers(self.t_cfg, self.tparams)
        assert [k for _, k in ref] == [k for _, k in port]
        return [(r, t, k, i not in carry)
                for i, ((r, k), (t, _)) in enumerate(zip(ref, port))]

    def stacked(self, name):
        """The reference's and the port's per-layer views of an enc-dec
        stack (``encoder`` or ``decoder``)."""
        import jax
        from repro_torch.models import transformer as T_T
        n = jax.tree.leaves(self.params[name])[0].shape[0]
        ref = [jax.tree.map(lambda leaf: leaf[i], self.params[name])
               for i in range(n)]
        return list(zip(ref, T_T._group_views(self.tparams[name], n)))


def inputs(pair: Pair, seed: int):
    """Seeded numpy tokens, labels and (paligemma) prefix embeddings or
    (seamless) frames."""
    from repro.models import registry as R_R
    cfg = pair.r_cfg
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(B, pair.seq)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, size=(B, pair.seq)).astype(np.int32)
    extra = None
    if pair.prefix_len:
        extra = rng.normal(size=(B, pair.prefix_len, cfg.d_model))
    elif pair.encdec:
        extra = rng.normal(size=(B, R_R.frames_for(cfg, pair.seq),
                                 cfg.d_model))
    return tok, lab, None if extra is None else extra.astype(np.float32)


def _positions(b, s):
    import jax.numpy as jnp
    return (jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s)),
            torch.arange(s, dtype=torch.int32)[None].expand(b, s))


def read(pair: Pair, seed: int) -> Reading:
    """Every block of ``pair`` on the reference's stream from ``seed``."""
    import jax
    with jax.default_device(jax.devices("cpu")[0]), torch.no_grad():
        if pair.encdec:
            return _read_encdec(pair, seed)
        return _read_decoder(pair, seed)


# --------------------------------------------------------------------------- #
# the port's side of each block
# --------------------------------------------------------------------------- #


def _port_mixer(pair, tlp, kind, h, tpos):
    from repro_torch.models import layers as T_L
    from repro_torch.models import rglru as T_RG
    from repro_torch.models import ssm as T_S
    from repro_torch.models import transformer as T_T
    t_cfg = pair.t_cfg
    if kind == "rglru":
        return T_RG.rglru_forward(t_cfg, tlp["rglru"], h)
    if kind == "ssm":
        return T_S.ssm_forward(t_cfg, tlp["ssm"], h)
    spec = (T_L.AttnSpec(causal=kind != "enc") if pair.encdec
            else T_T._attn_spec(t_cfg, kind, pair.prefix_len))
    return T_L.multihead_attention(t_cfg, tlp["attn"], h, spec, tpos)[0]


def _attn_blocks(pair, name, lp, tlp, h, pos, tpos, kind, causal=True,
                 kv=None):
    """The attention pieces on the reference's inputs: projections with
    rope on h (and kv), the core on the reference's q, k, v, the
    out-projection on the reference's core."""
    from repro_torch.kernels import ops as T_K
    from repro_torch.models import layers as T_L
    t_cfg = pair.t_cfg
    q, k, v, core, y = pair.attn_parts(lp, h, pos, kind=kind, causal=causal,
                                       kv=kv)
    th = _t(h)
    tsrc = th if kv is None else _t(kv)
    tq = T_L._project(th, tlp["wq"])
    tk = T_L._project(tsrc, tlp["wk"])
    tv = T_L._project(tsrc, tlp["wv"])
    if kv is None:
        tq = T_L.apply_rope(tq, tpos, t_cfg.rope_theta)
        tk = T_L.apply_rope(tk, tpos, t_cfg.rope_theta)

    def cat(*a):
        return np.concatenate([_np(t).reshape(-1) for t in a])

    out = [Block(f"{name}.qkv", "attn:qkv", cat(tq, tk, tv), cat(q, k, v))]
    rq, rk, rv = _t(q), _t(k), _t(v)
    spec = pair.spec(kind, causal)
    b, s, n_h, hd = rq.shape
    if kv is None and not spec.prefix_len:
        path = "flash"
        tcore = T_K.flash_attention_diff(
            rq.transpose(1, 2), rk.transpose(1, 2), rv.transpose(1, 2),
            causal=spec.causal, window=spec.window,
            softcap=spec.softcap).transpose(1, 2)
    else:
        # the port's einsum path, its out-projection an identity (exact)
        path = "cross" if kv is not None else "prefix"
        mask = None
        if kv is None:
            i = torch.arange(s, dtype=torch.int32)
            mask = T_L.attn_mask(i, i, T_L.AttnSpec(
                causal=spec.causal, window=spec.window,
                prefix_len=spec.prefix_len))[None, None, :, None, :]
        eye = torch.eye(n_h * hd, dtype=rq.dtype).reshape(n_h, hd, -1)
        tcore = T_L.cached_attention(t_cfg, eye, rq, rk, rv, mask,
                                     spec.softcap)
    out.append(Block(f"{name}.core", f"attn:core:{path}",
                     _np(tcore).reshape(core.shape), _np(core)))
    ty = _t(core).reshape(b, s, -1) @ tlp["wo"].reshape(
        -1, tlp["wo"].shape[-1])
    out.append(Block(f"{name}.out", "attn:out", _np(ty), _np(y)))
    return out


def _rglru_blocks(pair, name, lp, tlp, h):
    """The RG-LRU's pieces, each on the reference's inputs."""
    from repro_torch.models import layers as T_L
    from repro_torch.models import rglru as T_RG
    from repro_torch.models import ssm as T_S
    xr, log_a, b, hs, g, y = pair.rglru_parts(lp, h)
    th = _t(h)
    txr, _ = T_S._causal_conv(th @ tlp["w_rec"], tlp["conv_w"],
                              tlp["conv_b"], f32_out=True)
    tla, tb = T_RG._gates(tlp, _t(xr))
    ths = T_RG.linear_scan(_t(log_a), _t(b))
    tg = T_L.gelu((th @ tlp["w_gelu"]).float())
    ty = (_t(g) * _t(hs)).to(th.dtype) @ tlp["w_out"]
    return [Block(f"{name}.conv", "rglru:conv", _np(txr), _np(xr)),
            Block(f"{name}.log_a", "rglru:log_a", _np(tla), _np(log_a)),
            Block(f"{name}.gated_x", "rglru:gated_x", _np(tb), _np(b)),
            Block(f"{name}.scan", "rglru:scan", _np(ths), _np(hs)),
            Block(f"{name}.gelu", "rglru:gelu", _np(tg), _np(g)),
            Block(f"{name}.out", "rglru:out", _np(ty), _np(y))]


def _moe_blocks(pair, name, lp, tlp, h, scalars):
    """The MoE's pieces, each on the reference's inputs; the expert ids go
    to ``scalars`` as (port, reference)."""
    from repro_torch.models import moe as T_M
    t_cfg, m = pair.t_cfg, pair.t_cfg.moe
    logits, gates, eids, y, shared = pair.moe_parts(lp, h)
    th = _t(h)
    xt = th.reshape(-1, th.shape[-1])
    tgates, teids, _ = T_M.route(t_cfg, tlp["router"], xt)
    scalars[f"{name}.ids"] = (teids.numpy(), np.array(eids))
    out = [Block(f"{name}.router", "moe:router",
                 _np(xt.float() @ tlp["router"]), _np(logits)),
           Block(f"{name}.gates", "moe:gates", _np(tgates), _np(gates))]
    # the routed experts and the combine on the reference's gates and ids
    t = xt.shape[0]
    c = T_M.expert_capacity(t_cfg, t)
    slots, keep = T_M.dispatch_indices(torch.from_numpy(np.array(eids)),
                                       m.n_experts, c)
    rows = m.n_experts * c
    buf = torch.zeros((rows + 1, xt.shape[1]), dtype=xt.dtype)
    buf.index_copy_(0, slots, xt.repeat_interleave(m.top_k, dim=0))
    ebuf = buf[:rows].reshape(m.n_experts, c, -1)
    act = T_M._act(t_cfg)
    hh = act(torch.bmm(ebuf, tlp["w_gate"])) * torch.bmm(ebuf, tlp["w_up"])
    eo = torch.cat([torch.bmm(hh, tlp["w_down"]).reshape(rows, -1),
                    torch.zeros((1, xt.shape[1]), dtype=xt.dtype)])
    w = (_t(gates).reshape(-1) * keep.float()).to(xt.dtype)
    ty = (eo[slots] * w[:, None]).reshape(t, m.top_k, -1).sum(dim=1)
    out.append(Block(f"{name}.experts", "moe:experts", _np(ty), _np(y)))
    if shared is not None:
        sp = tlp["shared"]
        ts = (act(xt @ sp["w_gate"]) * (xt @ sp["w_up"])) @ sp["w_down"]
        out.append(Block(f"{name}.shared", "moe:shared", _np(ts),
                         _np(shared)))
    return out


def _head_and_loss(pair, x, lab, blocks, scalars, skip=0):
    """The head block on the stream's last output, then the loss block on
    the reference's logits (past ``skip`` prefix positions)."""
    import jax.numpy as jnp
    from repro_torch.models import layers as T_L
    t_cfg, tp, p = pair.t_cfg, pair.tparams, pair.params
    logits = pair.head(p["embed"]["table"], p["final_norm"], x)
    got = T_L.lm_logits(t_cfg, tp["embed"]["table"],
                        T_L.rms_norm(_t(x), tp["final_norm"],
                                     t_cfg.norm_eps, T_L._dtype(t_cfg)))
    v = pair.r_cfg.vocab_size
    blocks.append(Block("head", "head", _np(got)[..., :v],
                        _np(logits)[..., :v]))
    lg = logits[:, skip:]
    ce = pair.loss(lg, jnp.asarray(lab))
    got = T_L.softmax_cross_entropy(_t(lg), torch.from_numpy(lab),
                                    torch.ones(lab.shape))
    scalars["loss"] = (float(got), float(ce))
    return logits


def _read_decoder(pair: Pair, seed: int) -> Reading:
    import jax.numpy as jnp
    from repro_torch.models import layers as T_L
    from repro_torch.models import moe as T_M
    from repro_torch.models import transformer as T_T
    t_cfg, tp, p = pair.t_cfg, pair.tparams, pair.params
    bf16 = pair.dtype == "bfloat16"
    tok, lab, pre = inputs(pair, seed)
    dt = jnp.dtype(pair.dtype)
    pre_j = None if pre is None else jnp.asarray(pre).astype(dt)
    blocks: List[Block] = []
    scalars: Dict[str, tuple] = {}
    x = pair.embed(p["embed"]["table"], jnp.asarray(tok), pre_j)
    got = T_T._embed(t_cfg, tp["embed"]["table"], torch.from_numpy(tok))
    if pre is not None:
        got = torch.cat([_t(pre_j), got], dim=1)
    blocks.append(Block("embed", "embed", _np(got), _np(x)))
    pos, tpos = _positions(B, x.shape[1])
    xn = x                  # what ln1 reads: x, or the f32 sum handed on
    for i, (lp, tlp, kind, hand_on) in enumerate(pair.layers()):
        y, aux = pair.layer(lp, x, xn, pos, kind=kind, hand_on=hand_on)
        got, taux = T_T.apply_layer(t_cfg, tlp, kind, _t(xn), tpos,
                                    pair.prefix_len, hand_on=hand_on)
        ffn = "moe" if "moe" in lp else "mlp" if "mlp" in lp else None
        blocks.append(Block(f"L{i}", f"layer:{kind}" + (
            "+moe" if ffn == "moe" else ""), _np(got), _np(y)))
        h = pair.norm(xn, lp["ln1"])
        m = pair.mixer(lp, h, pos, kind=kind)
        tm = _port_mixer(pair, tlp, kind, _t(h), tpos)
        blocks.append(Block(f"L{i}.mixer", f"mixer:{kind}", _np(tm), _np(m)))
        if bf16 and kind == "rglru":
            blocks += _rglru_blocks(pair, f"L{i}", lp["rglru"],
                                    tlp["rglru"], h)
        elif bf16 and kind != "ssm":
            blocks += _attn_blocks(pair, f"L{i}", lp["attn"], tlp["attn"],
                                   h, pos, tpos, kind)
        if ffn:
            h2 = pair.ffn_in(lp, x, xn, pos, kind=kind)
            f, _ = pair.ffn(lp, h2)
            if ffn == "moe":
                tf, _ = T_M.moe_ffn(t_cfg, tlp["moe"], _t(h2))
                scalars[f"L{i}.aux"] = (float(taux), float(aux))
                if bf16:
                    blocks += _moe_blocks(pair, f"L{i}", lp["moe"],
                                          tlp["moe"], h2, scalars)
            else:
                tf = T_L.mlp(t_cfg, tlp["mlp"], _t(h2))
            blocks.append(Block(f"L{i}.ffn", f"ffn:{ffn}", _np(tf), _np(f)))
        xn = y
        x = y.astype(dt)
    logits = _head_and_loss(pair, xn, lab, blocks, scalars, pair.prefix_len)
    model = pair.forward(p, jnp.asarray(tok), pre_j)
    return Reading(blocks, scalars, {"logits": (_np(logits), _np(model))})


def _split_products(a: torch.Tensor, w: torch.Tensor, n: int) -> dict:
    """``a @ w`` (bf16) whole, and with its contraction cut in ``n`` rank
    blocks as the sharded model's row-parallel products cut it: the
    partials rounded to bf16 and summed in bf16 one rank at a time (a bf16
    psum), or kept in f32, summed and rounded once (an f32 psum)."""
    k = a.shape[-1] // n
    parts = [(a[..., i * k:(i + 1) * k].float()
              @ w[i * k:(i + 1) * k].float()) for i in range(n)]
    bf16 = parts[0].to(a.dtype)
    for part in parts[1:]:
        bf16 = bf16 + part.to(a.dtype)
    return {"whole": a @ w, "bf16 psum": bf16,
            "f32 psum": sum(parts).to(a.dtype)}


def read_row_parallel(pair: Pair, seed: int, n: int = 2) -> Dict[str, tuple]:
    """The row-parallel products of a dense bf16 config (attention's
    out-projection on the reference's core, the MLP's down projection on
    the port's hidden from the reference's ``ln2`` output), each layer on
    the reference's stream from ``seed``, whole and cut over ``n`` ranks
    (``_split_products``), against the reference's block output: per
    variant and block, the largest (share beyond one ulp, ``rel_err``)
    over the layers."""
    import jax.numpy as jnp
    from repro_torch.models import layers as T_L
    t_cfg, p = pair.t_cfg, pair.params
    tok, _, _ = inputs(pair, seed)
    dt = jnp.dtype(pair.dtype)
    x = pair.embed(p["embed"]["table"], jnp.asarray(tok), None)
    pos, _ = _positions(B, x.shape[1])
    act = T_L.gelu if t_cfg.mlp_activation == "gelu" else T_L.silu
    out: Dict[str, tuple] = {}

    def note(block, got, want):
        for variant, t in got.items():
            far, err = shares(_np(t), want)[1], rel_err(_np(t), want)
            was = out.get(f"{block} {variant}", (0.0, 0.0))
            out[f"{block} {variant}"] = (max(was[0], far), max(was[1], err))

    xn = x
    for lp, tlp, kind, hand_on in pair.layers():
        h = pair.norm(xn, lp["ln1"])
        core, y = pair.attn_parts(lp["attn"], h, pos, kind=kind)[3:]
        wo = tlp["attn"]["wo"]
        c = _t(core)
        note("attn:out", _split_products(
            c.reshape(c.shape[0], c.shape[1], -1),
            wo.reshape(-1, wo.shape[-1]), n), _np(y))
        h2 = pair.ffn_in(lp, x, xn, pos, kind=kind)
        f, _ = pair.ffn(lp, h2)
        mp = tlp["mlp"]
        xg, xu = T_L.fan(_t(h2), 2, mp["w_gate"].dtype)
        hid = act(xg @ mp["w_gate"]) * (xu @ mp["w_up"])
        note("ffn:mlp down", _split_products(hid, mp["w_down"], n), _np(f))
        xn = pair.layer(lp, x, xn, pos, kind=kind, hand_on=hand_on)[0]
        x = xn.astype(dt)
    return out


def _read_encdec(pair: Pair, seed: int) -> Reading:
    import jax.numpy as jnp
    from repro_torch.models import encdec as T_E
    from repro_torch.models import layers as T_L
    from repro_torch.models import transformer as T_T
    t_cfg, tp, p = pair.t_cfg, pair.tparams, pair.params
    bf16 = pair.dtype == "bfloat16"
    tok, lab, frames = inputs(pair, seed)
    fr = jnp.asarray(frames).astype(jnp.dtype(pair.dtype))
    blocks: List[Block] = []
    scalars: Dict[str, tuple] = {}
    x = fr
    pos, tpos = _positions(B, x.shape[1])
    for i, (lp, tlp) in enumerate(pair.stacked("encoder")):
        y = pair.enc_layer(lp, x, pos)
        got = T_E._encoder_layer(t_cfg, tlp, _t(x), tpos)
        blocks.append(Block(f"enc{i}", "layer:enc", _np(got), _np(y)))
        h = pair.norm(x, lp["ln1"])
        m = pair.mixer(lp, h, pos, kind="enc")
        tm = _port_mixer(pair, tlp, "enc", _t(h), tpos)
        blocks.append(Block(f"enc{i}.mixer", "mixer:enc", _np(tm), _np(m)))
        if bf16:
            blocks += _attn_blocks(pair, f"enc{i}", lp["attn"], tlp["attn"],
                                   h, pos, tpos, "enc", causal=False)
        h2 = pair.add_norm(x, m, lp["ln2"])
        f, _ = pair.ffn(lp, h2)
        tf = T_L.mlp(t_cfg, tlp["mlp"], _t(h2))
        blocks.append(Block(f"enc{i}.ffn", "ffn:mlp", _np(tf), _np(f)))
        x = y
    enc = pair.norm(x, p["enc_norm"])
    got = T_L.rms_norm(_t(x), tp["enc_norm"], t_cfg.norm_eps)
    blocks.append(Block("enc_norm", "enc_norm", _np(got), _np(enc)))
    chain = {"encode": (_np(enc), _np(pair.encode(p, fr)))}
    x = pair.embed(p["embed"]["table"], jnp.asarray(tok), None)
    got = T_T._embed(t_cfg, tp["embed"]["table"], torch.from_numpy(tok))
    blocks.append(Block("embed", "embed", _np(got), _np(x)))
    pos, tpos = _positions(B, x.shape[1])
    tenc = _t(enc)
    for i, (lp, tlp) in enumerate(pair.stacked("decoder")):
        y = pair.dec_layer(lp, x, pos, enc)
        got = T_E._decoder_layer(t_cfg, tlp, _t(x), tpos, tenc)
        blocks.append(Block(f"dec{i}", "layer:dec", _np(got), _np(y)))
        h = pair.norm(x, lp["ln1"])
        m = pair.mixer(lp, h, pos, kind="attn")
        tm = _port_mixer(pair, tlp, "attn", _t(h), tpos)
        blocks.append(Block(f"dec{i}.mixer", "mixer:dec", _np(tm), _np(m)))
        hx, h2 = pair.dec_parts(lp, x, pos, enc)
        c = pair.attn_parts(lp["xattn"], hx, pos, kind="attn", causal=False,
                            kv=enc)[-1]
        tc = T_L.multihead_attention(t_cfg, tlp["xattn"], _t(hx),
                                     T_L.AttnSpec(causal=False), tpos,
                                     kv_x=tenc)[0]
        blocks.append(Block(f"dec{i}.cross", "cross", _np(tc), _np(c)))
        if bf16:
            blocks += _attn_blocks(pair, f"dec{i}", lp["attn"], tlp["attn"],
                                   h, pos, tpos, "attn")
            blocks += _attn_blocks(pair, f"dec{i}.x", lp["xattn"],
                                   tlp["xattn"], hx, pos, tpos, "attn",
                                   causal=False, kv=enc)
        f, _ = pair.ffn(lp, h2)
        tf = T_L.mlp(t_cfg, tlp["mlp"], _t(h2))
        blocks.append(Block(f"dec{i}.ffn", "ffn:mlp", _np(tf), _np(f)))
        x = y
    logits = _head_and_loss(pair, x, lab, blocks, scalars)
    chain["logits"] = (_np(logits), _np(pair.forward(p, jnp.asarray(tok),
                                                     fr)))
    return Reading(blocks, scalars, chain)


# --------------------------------------------------------------------------- #
# the backward: each block's pullback of a seeded cotangent
# --------------------------------------------------------------------------- #


def _flat(tree, prefix: str = ""):
    """[(dotted path, leaf)] of nested dicts (keys sorted, as jax flattens
    them), lists and tuples of arrays or tensors; None leaves dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flat(v, f"{prefix}.{k}" if prefix else k)
    return out


def _cotangent(seed: int, name: str, shapes):
    """A numpy normal cotangent for each output of ``shapes`` (a tree of
    ``jax.ShapeDtypeStruct``), in its dtype, seeded by the token seed and
    the block's name."""
    import zlib
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
    return jax.tree.map(lambda s: jnp.asarray(
        rng.normal(size=s.shape).astype(np.float32)).astype(s.dtype), shapes)


def _port_grads(fn, tdiff, trest, ct):
    """``torch.autograd.grad`` of ``fn(*tdiff, *trest)`` against the
    reference's cotangent ``ct`` -> one {path: gradient} per ``tdiff``
    argument (a leaf autograd does not reach gets zeros)."""
    leaves, where = [], []

    def track(a, i, path):
        if isinstance(a, dict):
            return {k: track(v, i, f"{path}.{k}" if path else str(k))
                    for k, v in a.items()}
        if isinstance(a, list):
            return [track(v, i, f"{path}.{k}" if path else str(k))
                    for k, v in enumerate(a)]
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            t = a.detach().clone().requires_grad_()
            leaves.append(t)
            where.append((i, path))
            return t
        return a

    tracked = [track(a, i, "") for i, a in enumerate(tdiff)]
    with torch.enable_grad():
        out = fn(*tracked, *trest)
    outs = dict(_flat(out))
    pairs = [(outs[k], _t(c)) for k, c in _flat(ct)
             if isinstance(outs.get(k), torch.Tensor)
             and outs[k].requires_grad]
    gs = torch.autograd.grad([o for o, _ in pairs], leaves,
                             [c.to(o.dtype) for o, c in pairs],
                             allow_unused=True)
    res = [dict() for _ in tdiff]
    for (i, path), leaf, g in zip(where, leaves, gs):
        res[i][path] = torch.zeros_like(leaf) if g is None else g
    return res


def pullback(pair: "Pair", seed: int, name: str, kind: str, fn: str,
             port_fn, diff, rest, labels, static=(), ct=None):
    """One block's pullback in both packages -> (Blocks, the reference's
    output, its gradients).  ``fn`` names the reference's block method,
    run as ``jax.jit(jax.vjp(...))`` over the ``diff`` arguments with
    ``rest`` held (``static`` its static keywords); ``port_fn`` is the
    port's block on the same bits.  ``ct`` defaults to a numpy cotangent
    seeded by (``seed``, ``name``).  A Block per gradient leaf: named
    ``name.d<label>[.path]``, of kind ``kind:d<label>[.path]`` (a params
    argument's label is empty: ``layer:attn:dattn.wq``)."""
    static = tuple(sorted(static))
    if ct is None:
        ct = _cotangent(seed, name, pair.out_shape(diff, rest, fn=fn,
                                                   static=static))
    out, grads = pair.vjp(diff, rest, ct, fn=fn, static=static)
    tdiff = [_to_port(a) for a in diff]
    trest = [_to_port(a) for a in rest]
    tgrads = _port_grads(port_fn, tdiff, trest, ct)
    blocks = []
    for label, g, tg in zip(labels, grads, tgrads):
        for path, w in _flat(g):
            key = ".".join(k for k in (label, path) if k)
            blocks.append(Block(f"{name}.d{key}", f"{kind}:d{key}",
                                _np(tg[path]), _np(w),
                                str(w.dtype) == "bfloat16"))
    return blocks, out, grads


def _to_port(a):
    """A reference argument as the port's: arrays as tensors (ints too),
    dicts and tuples leaf by leaf."""
    if a is None or isinstance(a, (int, float, str)):
        return a
    if isinstance(a, dict):
        return {k: _to_port(v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_to_port(v) for v in a)
    arr = np.asarray(a)
    if arr.dtype.kind in "iu":
        return torch.from_numpy(np.array(arr))
    return _t(arr)


def _port_layer(pair, kind, hand_on):
    from repro_torch.models import transformer as T_T

    def fn(p, xn, tpos):
        y, aux = T_T.apply_layer(pair.t_cfg, p, kind, xn, tpos,
                                 pair.prefix_len, hand_on=hand_on)
        return y, (torch.zeros((), dtype=torch.float32) if aux is None
                   else aux)
    return fn


def _port_halves(pair, kind, hand_on):
    """The port's layer in its two halves, as ``apply_layer`` runs them
    (``Pair._g_half_mixer``, ``_g_half_ffn``)."""
    from repro_torch.models import layers as T_L
    from repro_torch.models import transformer as T_T
    t_cfg = pair.t_cfg
    dt = T_L._dtype(t_cfg)

    def mixer(p, xn, tpos):
        h = T_L.rms_norm(xn, p["ln1"], t_cfg.norm_eps, dt, held=True)
        y = _port_mixer(pair, p, kind, h, tpos)
        if t_cfg.post_norm:
            y = T_L.rms_norm(y, p["ln1_post"], t_cfg.norm_eps)
        return xn.to(dt) + y

    def ffn(p, x):
        y, aux = T_T._ffn(t_cfg, p, x, torch.zeros_like(x), hand_on=hand_on)
        return y, (torch.zeros(()) if aux is None else aux)
    return mixer, ffn


def _port_ffn(pair):
    from repro_torch.models import layers as T_L
    from repro_torch.models import moe as T_M

    def fn(p, h):
        if "moe" in p:
            return T_M.moe_ffn(pair.t_cfg, p["moe"], h)
        return T_L.mlp(pair.t_cfg, p["mlp"], h), torch.zeros(())
    return fn


def _port_qkv(pair):
    from repro_torch.models import layers as T_L
    theta = pair.t_cfg.rope_theta

    def fn(p, h, kv, tpos):
        src = h if kv is None else kv
        q, k, v = (T_L._project(a, p[w]) for a, w in
                   ((h, "wq"), (src, "wk"), (src, "wv")))
        if kv is None:
            q, k = T_L.apply_rope(q, tpos, theta), T_L.apply_rope(k, tpos,
                                                                  theta)
        return q, k, v
    return fn


def _port_core(pair, kind, causal, cross):
    """The port's attention core on q, k, v: flash, or the einsum path with
    an identity out-projection (exact)."""
    from repro_torch.kernels import ops as T_K
    from repro_torch.models import layers as T_L
    spec = pair.spec(kind, causal)

    def fn(q, k, v):
        b, s, n_h, hd = q.shape
        if not cross and not spec.prefix_len:
            return T_K.flash_attention_diff(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=spec.causal, window=spec.window,
                softcap=spec.softcap).transpose(1, 2)
        mask = None
        if not cross:
            i = torch.arange(s, dtype=torch.int32)
            mask = T_L.attn_mask(i, i, T_L.AttnSpec(
                causal=spec.causal, window=spec.window,
                prefix_len=spec.prefix_len))[None, None, :, None, :]
        eye = torch.eye(n_h * hd, dtype=q.dtype).reshape(n_h, hd, -1)
        return T_L.cached_attention(pair.t_cfg, eye, q, k, v, mask,
                                    spec.softcap).reshape(b, s, n_h, hd)
    return fn


def _port_attn_out(core, wo):
    b, s = core.shape[:2]
    return core.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def _attn_grads(pair, seed, name, p, h, pos, kind, causal=True, kv=None):
    """The attention pieces' pullbacks on the reference's inputs."""
    cross = kv is not None
    st = (("kind", kind), ("causal", causal))
    sub = {w: p[w] for w in ("wq", "wk", "wv")}
    diff, rest = ((sub, h, kv), (pos,)) if cross else ((sub, h), (None, pos))
    blocks, (q, k, v), _ = pullback(
        pair, seed, f"{name}.qkv", "attn:qkv", "_g_qkv", _port_qkv(pair),
        diff, rest, ("", "h", "kv"), static=st)
    b2, core, _ = pullback(
        pair, seed, f"{name}.core", "attn:core", "_g_core",
        _port_core(pair, kind, causal, cross), (q, k, v), (),
        ("q", "k", "v"), static=st + (("cross", cross),))
    b3, _, _ = pullback(pair, seed, f"{name}.out", "attn:out", "_g_out",
                        _port_attn_out, (core, p["wo"]), (),
                        ("core", "wo"))
    return blocks + b2 + b3


def _rglru_grads(pair, seed, name, p, h):
    """The RG-LRU's pieces' pullbacks, each on the reference's inputs (the
    port's conv as the model records it)."""
    from repro_torch.models import layers as T_L
    from repro_torch.models import rglru as T_RG
    cp = {w: p[w] for w in ("w_rec", "conv_w", "conv_b")}
    gp = {w: p[w] for w in ("w_a", "b_a", "w_x", "b_x", "lam")}
    blocks, xr, _ = pullback(
        pair, seed, f"{name}.conv", "rglru:conv", "_g_conv",
        lambda q, x: T_RG._conv(q, x)[0].float(), (cp, h), (), ("", "h"))
    b2, (log_a, b), _ = pullback(
        pair, seed, f"{name}.gates", "rglru:gates", "_g_gates",
        T_RG._gates, (gp, xr), (), ("", "xr"))
    b3, hs, _ = pullback(pair, seed, f"{name}.scan", "rglru:scan",
                         "_g_scan", T_RG.linear_scan, (log_a, b), (),
                         ("log_a", "b"))
    b4, g, _ = pullback(pair, seed, f"{name}.gelu", "rglru:gelu", "_g_gelu",
                        lambda w, x: T_L.gelu((x @ w).float()),
                        (p["w_gelu"], h), (), ("w_gelu", "h"))
    dt = pair.r_cfg.dtype
    b5, _, _ = pullback(
        pair, seed, f"{name}.out", "rglru:out", "_g_rglru_out",
        lambda a, c, w: (a * c).to(getattr(torch, dt)) @ w,
        (g, hs, p["w_out"]), (), ("g", "hs", "w_out"),
        static=(("dtype", dt),))
    return blocks + b2 + b3 + b4 + b5


def _moe_grads(pair, seed, name, p, h):
    """The MoE's pieces' pullbacks on the reference's inputs: the router's
    logits, the gates, the routed experts with the combine on the
    reference's gates and ids, the shared experts."""
    from repro_torch.kernels import ops as T_K
    from repro_torch.models import moe as T_M
    t_cfg = pair.t_cfg
    blocks, logits, _ = pullback(
        pair, seed, f"{name}.router", "moe:router", "_g_router",
        lambda r, x: x.reshape(-1, x.shape[-1]).float() @ r,
        (p["router"], h), (), ("router", "h"))
    b2, gates, _ = pullback(
        pair, seed, f"{name}.gates", "moe:gates", "_g_route_gates",
        lambda lg: T_K.moe_router_diff(lg, t_cfg.moe.top_k)[0], (logits,),
        (), ("logits",))
    eids = pair.moe_parts(p, h)[2]
    xt = h.reshape(-1, h.shape[-1])

    def experts(q, x, gt, ids):
        return T_M.routed_experts(t_cfg, q, x, gt, ids)

    ep = {w: p[w] for w in ("w_gate", "w_up", "w_down")}
    b3, _, _ = pullback(pair, seed, f"{name}.experts", "moe:experts",
                        "_g_experts", experts, (ep, xt, gates), (eids,),
                        ("", "xt", "gates"))
    out = blocks + b2 + b3
    if "shared" in p:
        act = T_M._act(t_cfg)
        b4, _, _ = pullback(
            pair, seed, f"{name}.shared", "moe:shared", "_g_shared",
            lambda sp, x: (act(x @ sp["w_gate"]) * (x @ sp["w_up"]))
            @ sp["w_down"], (p["shared"], xt), (), ("", "xt"))
        out += b4
    return out


def _port_head(pair):
    from repro_torch.models import layers as T_L
    t_cfg = pair.t_cfg

    def fn(table, scale, x):
        return T_L.lm_logits(t_cfg, table, T_L.rms_norm(
            x, scale, t_cfg.norm_eps, T_L._dtype(t_cfg)))
    return fn


def _port_loss(mask=True):
    from repro_torch.models import layers as T_L

    def fn(lg, lab):
        return T_L.softmax_cross_entropy(
            lg, lab, torch.ones(lab.shape) if mask else None)
    return fn


PROMPT = 12          # decode readings: prompt positions prefilled


def _cache_layers(pair, cache):
    """The reference cache's per-layer views, in ``Pair.layers`` order."""
    import jax
    from repro.models import transformer as R_T
    n_pre, n_grp, _ = R_T.structure(pair.r_cfg)
    per = R_T.pattern(pair.r_cfg)
    out = list(cache["prelude"])
    for g in range(n_grp):
        gc = jax.tree.map(lambda leaf: leaf[g], cache["blocks"])
        out += [gc[f"p{j}"] for j in range(len(per))]
    return out + list(cache["coda"])


def _new_rows(cache, pos):
    """A layer cache's entries that one decode step writes: a KV ring's
    row at ``pos % W`` (k, v, k_pos), or a recurrent state and conv tail
    whole."""
    if "k_pos" not in cache:
        return cache
    w = cache["k"].shape[1]
    return {k: v[:, int(pos) % w] for k, v in cache.items()}


def read_decode(pair: Pair, seed: int) -> Reading:
    """One decode step after a prefill of ``PROMPT`` seeded tokens, block
    by block: each layer (new cache rows as outputs too), its mixer's step
    (seamless: the self and cross steps), the head; each layer again as
    the serving engine's vmapped step reads it (the port with a (B,)
    position vector); the chain: the jitted layers, chained, against the
    reference's own ``decode_step``."""
    import jax
    with jax.default_device(jax.devices("cpu")[0]), torch.no_grad():
        return _read_decode(pair, seed)


def _read_decode(pair: Pair, seed: int) -> Reading:
    import jax
    import jax.numpy as jnp
    from repro.models import encdec as R_E
    from repro.models import transformer as R_T
    from repro_torch.models import encdec as T_E
    from repro_torch.models import layers as T_L
    from repro_torch.models import transformer as T_T
    cfg, t_cfg, p = pair.r_cfg, pair.t_cfg, pair.params
    dt = jnp.dtype(pair.dtype)
    tok, _, extra = inputs(pair, seed)
    prompt, nxt = jnp.asarray(tok[:, :PROMPT]), jnp.asarray(tok[:, PROMPT:
                                                                PROMPT + 1])
    max_len = PROMPT + 4
    if pair.encdec:
        cache = pair.prefill(p, R_E.init_cache(cfg, B, max_len,
                                               extra.shape[1]),
                             jnp.asarray(extra).astype(dt), prompt)
    else:
        cache = pair.prefill(p, R_T.init_cache(cfg, B, max_len), prompt)
    cache = jax.tree.map(np.asarray, cache)
    pos = cache["pos"]
    tpos = torch.tensor(int(pos), dtype=torch.int32)
    posv = jnp.full((B,), pos, jnp.int32)
    tposv = torch.full((B,), int(pos), dtype=torch.int32)
    blocks: List[Block] = []
    table = p["embed"]["table"]
    x = pair.embed(table, nxt, None)

    def add(name, kind, got, want):
        """A Block per output: the step's output ("out") and each new
        cache entry."""
        tg = dict(_flat(got))
        for path, w in _flat(want):
            leaf = path.split(".")[-1] if path else ""
            leaf = "out" if leaf in ("", "0") else leaf
            blocks.append(Block(f"{name}.{leaf}", f"{kind}:{leaf}",
                                _np(tg[path]), _np(w)))

    if pair.encdec:
        xn = x
        for i, (lp, tlp) in enumerate(pair.stacked("decoder")):
            c = {k: cache["self"][k][i] for k in ("k", "v", "k_pos")}
            c.update(ck=cache["cross"]["k"][i], cv=cache["cross"]["v"][i])
            y, nc = pair.d_dec_layer(lp, c, x, pos)
            tc = _to_port(c)
            ty = _port_dec_step(t_cfg, tlp, tc, _t(x), tpos)
            own = ("k", "v", "k_pos")
            add(f"dec{i}", "dlayer:dec",
                (ty, _new_rows({k: tc[k] for k in own}, pos)),
                (y, _new_rows(nc, pos)))
            h = pair.norm(x, lp["ln1"])
            ys, nc = pair.d_self(lp["attn"], {k: c[k] for k in
                                              ("k", "v", "k_pos")}, h, pos)
            tc = _to_port({k: c[k] for k in ("k", "v", "k_pos")})
            tys = T_T._ring_attention_step(t_cfg, tlp["attn"], _t(h), tc,
                                           tpos, T_L.AttnSpec(causal=True))
            add(f"dec{i}.self", "dstep:self", (tys, _new_rows(tc, pos)),
                (ys, _new_rows(nc, pos)))
            xc = x + ys
            yc = pair.d_cross(lp, xc, c["ck"], c["cv"])
            txc = _t(xc)
            tyc = txc + T_E._cross_attn(
                t_cfg, tlp, T_L.rms_norm(txc, tlp["ln_x"], t_cfg.norm_eps),
                _t(c["ck"]), _t(c["cv"]))
            add(f"dec{i}.cross", "dstep:cross", tyc, yc)
            x = xn = y
        chain = pair.decode_step(p, cache, nxt)[0]
    else:
        xn = x
        for i, ((lp, tlp, kind, hand_on), c) in enumerate(
                zip(pair.layers(), _cache_layers(pair, cache))):
            st = dict(kind=kind, hand_on=hand_on)
            y, nc = pair.d_layer(lp, c, x, xn, pos, **st)
            tc = _to_port(c)
            ty = T_T.decode_layer(t_cfg, tlp, kind, tc, _t(xn), tpos,
                                  hand_on=hand_on)
            add(f"L{i}", f"dlayer:{kind}", (ty, _new_rows(tc, pos)),
                (y, _new_rows(nc, pos)))
            yv, ncv = pair.d_rows(lp, c, x, xn, posv, **st)
            tc = _to_port(c)
            tyv = T_T.decode_layer(t_cfg, tlp, kind, tc, _t(xn), tposv,
                                   hand_on=hand_on)
            add(f"L{i}.rows", f"drows:{kind}", (tyv, _new_rows(tc, pos)),
                (yv, _new_rows(ncv, pos)))
            h = pair.norm(xn, lp["ln1"])
            ym, nm = pair.d_mixer(lp, c, h, pos, kind=kind)
            tc = _to_port(c)
            th = _t(h)
            if kind == "rglru":
                from repro_torch.models import rglru as T_RG
                tym = T_RG.rglru_decode_step(t_cfg, tlp["rglru"], tc, th)[0]
            elif kind == "ssm":
                from repro_torch.models import ssm as T_S
                tym = T_S.ssm_decode_step(t_cfg, tlp["ssm"], tc, th)[0]
            else:
                tym = T_T._ring_attention_step(t_cfg, tlp["attn"], th, tc,
                                               tpos,
                                               T_T._attn_spec(t_cfg, kind))
            add(f"L{i}.mixer", f"dstep:{kind}", (tym, _new_rows(tc, pos)),
                (ym, _new_rows(nm, pos)))
            xn = y
            x = y.astype(dt)
        chain = pair.decode_step(p, cache, nxt)[0]
    logits = pair.head(table, p["final_norm"], xn)
    got = _port_head(pair)(pair.tparams["embed"]["table"],
                           pair.tparams["final_norm"], _t(xn))
    v = cfg.vocab_size
    blocks.append(Block("head", "dhead", _np(got)[..., :v],
                        _np(logits)[..., :v]))
    return Reading(blocks, {}, {"logits": (_np(logits), _np(chain))})


def _port_dec_step(t_cfg, lp, c, x, pos):
    """The port's enc-dec decode layer on one layer's caches (in place)."""
    from repro_torch.models import encdec as T_E
    return T_E.decode_layer(t_cfg, lp, {k: c[k] for k in ("k", "v", "k_pos")},
                            c["ck"], c["cv"], x, pos)


def read_grad(pair: Pair, seed: int) -> Reading:
    """Every block's pullback on the reference's stream from ``seed``,
    and the chain: the reference's jitted block pullbacks, chained from
    the loss down, against its ``jax.value_and_grad(compute_loss)``, and
    the port's whole-model gradients against the same, leaf by leaf."""
    import jax
    with jax.default_device(jax.devices("cpu")[0]):
        if pair.encdec:
            return _read_encdec_grad(pair, seed)
        return _read_decoder_grad(pair, seed)


def _model_blocks(pair, batch, tbatch, blocks, scalars, chain, layer_grads,
                  table_grad, norm_grad):
    """The model's gradients: the reference's ``value_and_grad`` of
    ``compute_loss`` against the port's (a Block per leaf, of its own
    kind "model:d<leaf>") and against the reference's chained block
    pullbacks (``chain``)."""
    import jax
    from repro_torch.models import registry as T_R
    loss, grads = pair.model_grad(pair.params, batch)
    (tg,) = _port_grads(
        lambda q: T_R.compute_loss(pair.t_cfg, q, tbatch)[0], [pair.tparams],
        [], np.float32(1.0))
    with torch.enable_grad():
        tloss = T_R.compute_loss(pair.t_cfg, pair.tparams, tbatch)[0]
    scalars["model:loss"] = (float(tloss), float(loss))
    for path, w in _flat(grads):
        blocks.append(Block(f"model.d{path}", f"model:d{path}",
                            _np(tg[path]), _np(w)))
    n_pre, n_grp, _ = _structure(pair)
    per = len(layer_grads) and _per(pair)
    for i, gl in enumerate(layer_grads):
        if i < n_pre:
            mg = grads["prelude"][i]
        elif i < n_pre + n_grp * per:
            g, j = divmod(i - n_pre, per)
            mg = jax.tree.map(lambda leaf: leaf[g], grads["blocks"][f"p{j}"])
        else:
            mg = grads["coda"][i - n_pre - n_grp * per]
        want = dict(_flat(mg))
        for path, got in _flat(gl):
            chain[f"L{i}.d{path}"] = (_np(got), _np(want[path]))
    chain["embed.dtable"] = (_np(table_grad), _np(grads["embed"]["table"]))
    chain["final_norm"] = (_np(norm_grad), _np(grads["final_norm"]))


def _structure(pair):
    from repro.models import transformer as R_T
    return R_T.structure(pair.r_cfg)


def _per(pair):
    from repro.models import transformer as R_T
    return len(R_T.pattern(pair.r_cfg))


def _read_decoder_grad(pair: Pair, seed: int) -> Reading:
    import jax.numpy as jnp
    from repro_torch.models import transformer as T_T
    t_cfg, p = pair.t_cfg, pair.params
    bf16 = pair.dtype == "bfloat16"
    tok, lab, pre = inputs(pair, seed)
    dt = jnp.dtype(pair.dtype)
    tok_j, lab_j = jnp.asarray(tok), jnp.asarray(lab)
    pre_j = None if pre is None else jnp.asarray(pre).astype(dt)
    table = p["embed"]["table"]

    def port_embed(tb, tk, pr):
        x = T_T._embed(t_cfg, tb, tk)
        return x if pr is None else torch.cat([pr, x], dim=1)

    blocks, x, _ = pullback(pair, seed, "embed", "embed", "_embed",
                            port_embed, (table,), (tok_j, pre_j), ("table",))
    pos, _ = _positions(B, x.shape[1])
    xn = x
    layers = pair.layers()
    ins = []
    for i, (lp, _, kind, hand_on) in enumerate(layers):
        ins.append(xn)
        ffn = "moe" if "moe" in lp else "mlp" if "mlp" in lp else None
        bl, (y, _), _ = pullback(
            pair, seed, f"L{i}", f"layer:{kind}" + (
                "+moe" if ffn == "moe" else ""), "_g_layer",
            _port_layer(pair, kind, hand_on), (lp, xn), (pos,), ("", "x"),
            static=(("kind", kind), ("hand_on", hand_on)))
        blocks += bl
        mk = kind if kind in ("rglru", "ssm") else "attn"
        if ffn:
            # the layer in halves, each on the reference's own input
            first = [w for w in ("ln1", mk, "ln1_post") if w in lp]
            second = [w for w in ("ln2", ffn, "ln2_post") if w in lp]
            mix, fn2 = _port_halves(pair, kind, hand_on)
            bl, xm, _ = pullback(
                pair, seed, f"L{i}.half1", f"half:{kind}", "_g_half_mixer",
                mix, ({w: lp[w] for w in first}, xn), (pos,), ("", "x"),
                static=(("kind", kind),))
            blocks += bl
            bl, _, _ = pullback(
                pair, seed, f"L{i}.half2", f"half:{ffn}", "_g_half_ffn", fn2,
                ({w: lp[w] for w in second}, xm), (), ("", "x"),
                static=(("hand_on", hand_on),))
            blocks += bl
        h = pair.norm(xn, lp["ln1"])
        bl, _, _ = pullback(
            pair, seed, f"L{i}.mixer", f"mixer:{kind}", "_mixer",
            lambda q, hh, tp: _port_mixer(pair, q, kind, hh, tp),
            ({mk: lp[mk]}, h), (pos,), ("", "h"), static=(("kind", kind),))
        blocks += bl
        if bf16 and kind == "rglru":
            blocks += _rglru_grads(pair, seed, f"L{i}", lp["rglru"], h)
        elif bf16 and kind != "ssm":
            blocks += _attn_grads(pair, seed, f"L{i}", lp["attn"], h, pos,
                                  kind)
        if ffn:
            h2 = pair.ffn_in(lp, x, xn, pos, kind=kind)
            bl, _, _ = pullback(pair, seed, f"L{i}.ffn", f"ffn:{ffn}",
                                "_ffn", _port_ffn(pair), ({ffn: lp[ffn]}, h2),
                                (), ("", "h"))
            blocks += bl
            if bf16 and ffn == "moe":
                blocks += _moe_grads(pair, seed, f"L{i}", lp["moe"], h2)
        xn = y
        x = y.astype(dt)
    bl, logits, _ = pullback(pair, seed, "head", "head", "_g_head",
                             _port_head(pair), (table, p["final_norm"], xn),
                             (), ("table", "final_norm", "x"))
    blocks += bl
    lg = logits[:, pair.prefix_len:]
    bl, _, _ = pullback(pair, seed, "loss", "loss", "_g_loss", _port_loss(),
                        (lg,), (lab_j,), ("logits",))
    blocks += bl

    # the chain, from the loss down with the model's own cotangents
    f32 = jnp.float32
    aux_w = jnp.asarray(pair.r_cfg.moe.router_aux_weight
                        if pair.r_cfg.moe else 0.0, f32)
    _, (ct,) = pair.vjp((lg,), (lab_j,), jnp.ones((), f32), fn="_g_loss",
                        static=(("mask", False),))
    ct = jnp.zeros_like(logits).at[:, pair.prefix_len:].set(ct)
    _, (g_table, g_norm, ct) = pair.vjp((table, p["final_norm"], xn), (), ct,
                                        fn="_g_head", static=())
    layer_grads = [None] * len(layers)
    for i in reversed(range(len(layers))):
        lp, _, kind, hand_on = layers[i]
        _, (layer_grads[i], ct) = pair.vjp(
            (lp, ins[i]), (pos,), (ct, aux_w), fn="_g_layer",
            static=(("hand_on", hand_on), ("kind", kind)))
    _, (g_emb,) = pair.vjp((table,), (tok_j, pre_j), ct, fn="_embed",
                           static=())
    batch = {"tokens": tok_j, "labels": lab_j}
    tbatch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    if pre is not None:
        batch["prefix_embeds"] = pre_j
        tbatch["prefix_embeds"] = _t(pre_j)
    scalars: Dict[str, tuple] = {}
    chain: Dict[str, tuple] = {}
    _model_blocks(pair, batch, tbatch, blocks, scalars, chain, layer_grads,
                  g_emb + g_table, g_norm)
    return Reading(blocks, scalars, chain)


def _read_encdec_grad(pair: Pair, seed: int) -> Reading:
    import jax.numpy as jnp
    from repro_torch.models import encdec as T_E
    from repro_torch.models import layers as T_L
    from repro_torch.models import transformer as T_T
    t_cfg, p = pair.t_cfg, pair.params
    bf16 = pair.dtype == "bfloat16"
    tok, lab, frames = inputs(pair, seed)
    tok_j, lab_j = jnp.asarray(tok), jnp.asarray(lab)
    fr = jnp.asarray(frames).astype(jnp.dtype(pair.dtype))
    blocks: List[Block] = []
    x = fr
    pos, _ = _positions(B, x.shape[1])
    enc_stack = pair.stacked("encoder")
    enc_ins = []
    for i, (lp, _) in enumerate(enc_stack):
        enc_ins.append(x)
        bl, y, _ = pullback(
            pair, seed, f"enc{i}", "layer:enc", "_enc_layer",
            lambda q, xx, tp: T_E._encoder_layer(t_cfg, q, xx, tp), (lp, x),
            (pos,), ("", "x"))
        blocks += bl
        h = pair.norm(x, lp["ln1"])
        bl, m, _ = pullback(
            pair, seed, f"enc{i}.mixer", "mixer:enc", "_mixer",
            lambda q, hh, tp: _port_mixer(pair, q, "enc", hh, tp),
            ({"attn": lp["attn"]}, h), (pos,), ("", "h"),
            static=(("kind", "enc"),))
        blocks += bl
        if bf16:
            blocks += _attn_grads(pair, seed, f"enc{i}", lp["attn"], h, pos,
                                  "enc", causal=False)
        h2 = pair.add_norm(x, m, lp["ln2"])
        bl, _, _ = pullback(pair, seed, f"enc{i}.ffn", "ffn:mlp", "_ffn",
                            _port_ffn(pair), ({"mlp": lp["mlp"]}, h2), (),
                            ("", "h"))
        blocks += bl
        x = y
    bl, enc, _ = pullback(
        pair, seed, "enc_norm", "enc_norm", "_g_norm",
        lambda xx, sc: T_L.rms_norm(xx, sc, t_cfg.norm_eps),
        (x, p["enc_norm"]), (), ("x", "enc_norm"))
    blocks += bl
    enc_last = x
    table = p["embed"]["table"]
    bl, x, _ = pullback(
        pair, seed, "embed", "embed", "_embed",
        lambda tb, tk, pr: T_T._embed(t_cfg, tb, tk), (table,),
        (tok_j, None), ("table",))
    blocks += bl
    pos, _ = _positions(B, x.shape[1])
    dec_stack = pair.stacked("decoder")
    dec_ins = []
    for i, (lp, _) in enumerate(dec_stack):
        dec_ins.append(x)
        bl, y, _ = pullback(
            pair, seed, f"dec{i}", "layer:dec", "_g_dec_layer",
            lambda q, xx, e, tp: T_E._decoder_layer(t_cfg, q, xx, tp, e),
            (lp, x, enc), (pos,), ("", "x", "enc"))
        blocks += bl
        h = pair.norm(x, lp["ln1"])
        bl, _, _ = pullback(
            pair, seed, f"dec{i}.mixer", "mixer:dec", "_mixer",
            lambda q, hh, tp: _port_mixer(pair, q, "attn", hh, tp),
            ({"attn": lp["attn"]}, h), (pos,), ("", "h"),
            static=(("kind", "attn"),))
        blocks += bl
        hx, h2 = pair.dec_parts(lp, x, pos, enc)
        bl, _, _ = pullback(
            pair, seed, f"dec{i}.cross", "cross", "_g_cross",
            lambda q, hh, e, tp: T_L.multihead_attention(
                t_cfg, q, hh, T_L.AttnSpec(causal=False), tp, kv_x=e)[0],
            (lp["xattn"], hx, enc), (pos,), ("", "hx", "enc"))
        blocks += bl
        if bf16:
            blocks += _attn_grads(pair, seed, f"dec{i}", lp["attn"], h, pos,
                                  "attn")
            blocks += _attn_grads(pair, seed, f"dec{i}.x", lp["xattn"], hx,
                                  pos, "attn", causal=False, kv=enc)
        bl, _, _ = pullback(pair, seed, f"dec{i}.ffn", "ffn:mlp", "_ffn",
                            _port_ffn(pair), ({"mlp": lp["mlp"]}, h2), (),
                            ("", "h"))
        blocks += bl
        x = y
    bl, logits, _ = pullback(pair, seed, "head", "head", "_g_head",
                             _port_head(pair), (table, p["final_norm"], x),
                             (), ("table", "final_norm", "x"))
    blocks += bl
    bl, _, _ = pullback(pair, seed, "loss", "loss", "_g_loss", _port_loss(),
                        (logits,), (lab_j,), ("logits",))
    blocks += bl

    # the chain, from the loss down
    f32 = jnp.float32
    _, (ct,) = pair.vjp((logits,), (lab_j,), jnp.ones((), f32),
                        fn="_g_loss", static=(("mask", False),))
    _, (g_table, g_norm, ct) = pair.vjp((table, p["final_norm"], x), (), ct,
                                        fn="_g_head", static=())
    dec_grads = [None] * len(dec_stack)
    for i in reversed(range(len(dec_stack))):
        _, (dec_grads[i], ct, _) = pair.vjp(
            (dec_stack[i][0], dec_ins[i], enc), (pos,), ct,
            fn="_g_dec_layer", static=())
    # the encoder's cotangent as the model's scan sums it over the layers
    _, (ct_lg,) = pair.vjp((logits,), (lab_j,), jnp.ones((), f32),
                           fn="_g_loss", static=(("mask", False),))
    _, (_, ct_enc) = pair.vjp((p, enc), (tok_j,), ct_lg, fn="_g_decoder",
                              static=())
    _, (g_emb,) = pair.vjp((table,), (tok_j, None), ct, fn="_embed",
                           static=())
    _, (ct, g_enc_norm) = pair.vjp((enc_last, p["enc_norm"]), (), ct_enc,
                                   fn="_g_norm", static=())
    epos, _ = _positions(B, fr.shape[1])
    enc_grads = [None] * len(enc_stack)
    for i in reversed(range(len(enc_stack))):
        _, (enc_grads[i], ct) = pair.vjp((enc_stack[i][0], enc_ins[i]),
                                         (epos,), ct, fn="_enc_layer",
                                         static=())
    batch = {"tokens": tok_j, "labels": lab_j, "frames": fr}
    tbatch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
              "frames": _t(fr)}
    scalars: Dict[str, tuple] = {}
    chain: Dict[str, tuple] = {}
    import jax
    from repro_torch.models import registry as T_R
    loss, grads = pair.model_grad(p, batch)
    (tg,) = _port_grads(
        lambda q: T_R.compute_loss(t_cfg, q, tbatch)[0], [pair.tparams], [],
        np.float32(1.0))
    with torch.enable_grad():
        tloss = T_R.compute_loss(t_cfg, pair.tparams, tbatch)[0]
    scalars["model:loss"] = (float(tloss), float(loss))
    for path, w in _flat(grads):
        blocks.append(Block(f"model.d{path}", f"model:d{path}",
                            _np(tg[path]), _np(w)))
    for name, got_list in (("encoder", enc_grads), ("decoder", dec_grads)):
        for i, gl in enumerate(got_list):
            want = dict(_flat(jax.tree.map(lambda leaf: leaf[i],
                                           grads[name])))
            for path, got in _flat(gl):
                chain[f"{name}{i}.d{path}"] = (_np(got), _np(want[path]))
    chain["embed.dtable"] = (_np(g_emb + g_table),
                             _np(grads["embed"]["table"]))
    chain["final_norm"] = (_np(g_norm), _np(grads["final_norm"]))
    chain["enc_norm"] = (_np(g_enc_norm), _np(grads["enc_norm"]))
    return Reading(blocks, scalars, chain)


@functools.lru_cache(maxsize=None)
def reading(arch: str, dtype: str, seed: int) -> Reading:
    """``read`` once per config, dtype and seed (the chain test reuses the
    block test's reading)."""
    return read(Pair.of(arch, dtype), seed)


def report(r: Reading) -> List[str]:
    """One line per block and scalar: its reading."""
    out = []
    for blk in r.blocks:
        d, f = shares(blk.got, blk.want)
        out.append(f"{blk.name:12s} {blk.kind:18s} differ {d:.4%} far "
                   f"{f:.4%} rel {rel_err(blk.got, blk.want):.3e}")
    for k, (g, w) in r.scalars.items():
        out.append(f"{k:12s} " + (f"equal {np.mean(g == w):.4%}"
                                  if np.ndim(g) else f"|d| {abs(g - w):.3e}"))
    return out


def check(r: Reading, dtype: str, bounds: Dict[str, tuple]) -> None:
    """Hold every block of a reading to its bound, and print the reading.

    bf16: each block kind's entry in ``bounds`` is ("shares", bound on the
    differ share, bound on the far share, measured differ, measured far)
    or, for a piece computed in f32 on the reference's f32 inputs, ("rel",
    bound on ``rel_err``, measured).  f32: every block to atol and rtol
    1e-5, today's algorithm-level tolerance.  Both: the loss (on the
    reference's logits) and each MoE aux term to 1e-5, expert ids equal."""
    print("\n".join(report(r)))
    bad = []
    for blk in r.blocks:
        if dtype == "float32":
            if not np.allclose(blk.got, blk.want, atol=1e-5, rtol=1e-5):
                bad.append(f"{blk.name} ({blk.kind}): max |d| "
                           f"{np.abs(blk.got - blk.want).max():.3e}")
            continue
        b = bounds[blk.kind]
        if b[0] == "rel":
            e = rel_err(blk.got, blk.want)
            if e > b[1]:
                bad.append(f"{blk.name} ({blk.kind}): rel {e:.3e} > {b[1]}")
            continue
        d, f = shares(blk.got, blk.want)
        if d > b[1] or f > b[2]:
            bad.append(f"{blk.name} ({blk.kind}): differ {d:.4%} far "
                       f"{f:.4%} > bounds {b[1]:.4%} {b[2]:.4%}")
    for k, (g, w) in r.scalars.items():
        if np.ndim(g):
            if not np.array_equal(g, w):
                bad.append(f"{k}: {np.mean(g != w):.4%} differ")
        elif abs(g - w) > 1e-5:
            bad.append(f"{k}: {g!r} vs {w!r}")
    assert not bad, "\n".join(bad)


def check_layer_body(arch: str) -> None:
    """``Pair._layer`` on a rounded input, handing nothing on, is
    ``transformer.apply_layer`` to the bit, in both dtypes, for every
    layer of ``arch`` on seed 5's embedding (paligemma's with its
    prefix)."""
    import jax
    import jax.numpy as jnp
    for dtype in DTYPES:
        pair = Pair.of(arch, dtype)
        tok, _, pre = inputs(pair, SEEDS[0])
        with jax.default_device(jax.devices("cpu")[0]):
            x = pair.embed(pair.params["embed"]["table"], jnp.asarray(tok),
                           None if pre is None else
                           jnp.asarray(pre).astype(jnp.dtype(dtype)))
            pos, _ = _positions(x.shape[0], x.shape[1])
            for lp, _, kind, _ in pair.layers():
                want, aux = pair.apply_layer(lp, x, pos, kind=kind)
                got, gaux = pair.layer(lp, x, x, pos, kind=kind,
                                       hand_on=False)
                assert np.array_equal(_np(got), _np(want)), (arch, dtype)
                assert float(gaux) == float(aux), (arch, dtype)


def by_kind(readings) -> Dict[str, tuple]:
    """block kind -> (largest differ share, largest far share, largest
    ``rel_err``) over the readings' blocks."""
    out: Dict[str, tuple] = {}
    for r in readings:
        for blk in r.blocks:
            d, f = shares(blk.got, blk.want)
            e = rel_err(blk.got, blk.want)
            od, of, oe = out.get(blk.kind, (0.0, 0.0, 0.0))
            out[blk.kind] = (max(od, d), max(of, f), max(oe, e))
    return out


def bound(measured: float, floor: float = 2e-4) -> float:
    """The bound on a reading: the measured value times 1.5 and at least
    ``floor`` above it (0.02 % for a share), rounded up to two significant
    digits; 0 stays 0."""
    b = max(measured * 1.5, measured + floor)
    if b == 0:
        return 0.0
    e = 10 ** (np.floor(np.log10(b)) - 1)
    return float(f"{np.ceil(b / e - 1e-9) * e:.2g}")


def bounds_of(readings, dtype: str) -> Dict[str, tuple]:
    """Each block kind's bound over ``readings``, beside the largest
    measured value: bf16 ("shares", differ bound, far bound, differ, far);
    f32 ("rel", bound on ``rel_err``, measured); a scalar ("abs", bound on
    the gap, measured); integer outputs ("equal",).  A share whose bound
    would reach 1 (measured above 2/3) holds nothing: its bound is None
    and the kind is held by ``rel_err`` as well, ("shares", differ bound
    or None, far bound or None, differ, far, rel bound, rel)."""
    out = {}
    for k, (d, f, e) in sorted(by_kind(readings).items()):
        d, f, e = (float(f"{v:.3g}") for v in (d, f, e))
        if dtype != "bfloat16":
            out[k] = ("rel", bound(e, 0.0), e)
            continue
        bd, bf = bound(d), bound(f)
        out[k] = ("shares", bd, bf, d, f)
        if max(bd, bf) >= 1.0:
            out[k] = ("shares", bd if bd < 1.0 else None,
                      bf if bf < 1.0 else None, d, f, bound(e, 0.0), e)
    gaps: Dict[str, float] = {}
    for r in readings:
        for k, (g, w) in r.scalars.items():
            kind = k.split(".")[-1]
            if np.ndim(g):
                out[kind] = ("equal",)
            else:
                gaps[kind] = max(gaps.get(kind, 0.0), abs(g - w))
    for kind, m in sorted(gaps.items()):
        m = float(f"{m:.3g}")
        out[kind] = ("abs", bound(m, 1e-6), m)
    return out


def compact(bounds: Dict[str, tuple]) -> Dict[str, tuple]:
    """An f32 reading's bounds as the test files hold them: one ``rel``
    bound for every block ("*", the largest), the scalars as they are."""
    rel = [b for b in bounds.values() if b[0] == "rel"]
    out = {k: b for k, b in bounds.items() if b[0] != "rel"}
    if rel:
        m = max(b[2] for b in rel)
        out["*"] = ("rel", bound(m, 0.0), m)
    return out


def check_bounds(r: Reading, bounds: Dict[str, tuple]) -> None:
    """Hold every block and scalar of a reading to its kind's entry in
    ``bounds`` (as ``bounds_of`` writes them), and print the reading.  A
    share bound of 1 or more is refused: it would hold nothing."""
    print("\n".join(report(r)))
    bad = []
    for blk in r.blocks:
        b = bounds.get(blk.kind) or bounds["*"]
        if b[0] == "rel":
            e = rel_err(blk.got, blk.want)
            if e > b[1]:
                bad.append(f"{blk.name} ({blk.kind}): rel {e:.3e} > {b[1]}")
            continue
        assert all(v is None or v < 1.0 for v in b[1:3]), (blk.kind, b)
        d, f = shares(blk.got, blk.want)
        for name, got, lim in (("differ", d, b[1]), ("far", f, b[2])):
            if lim is not None and got > lim:
                bad.append(f"{blk.name} ({blk.kind}): {name} {got:.4%} > "
                           f"{lim:.4%}")
        if len(b) > 5 and rel_err(blk.got, blk.want) > b[5]:
            bad.append(f"{blk.name} ({blk.kind}): rel "
                       f"{rel_err(blk.got, blk.want):.3e} > {b[5]}")
    for k, (g, w) in r.scalars.items():
        b = bounds[k.split(".")[-1]]
        if np.ndim(g):
            if not np.array_equal(g, w):
                bad.append(f"{k}: {np.mean(g != w):.4%} differ")
        elif abs(g - w) > b[1]:
            bad.append(f"{k}: |{g!r} - {w!r}| > {b[1]}")
    assert not bad, "\n".join(bad)


CHAIN_F32_REL = 1.2e-5     # an f32 leaf's chain: sum order (measured 7.8e-6)


def check_chain(r: Reading, rel: Dict[str, float]) -> None:
    """The chain: every entry of a bf16 leaf the model's own bits, every
    f32 leaf's within ``CHAIN_F32_REL`` of them (its sums in another
    order), but where ``rel`` names a bound on ``rel_err`` for the
    entries whose name starts with its key."""
    import ml_dtypes
    bad = []
    for k, (g, w) in r.chain.items():
        lim = next((v for p_, v in rel.items() if k.startswith(p_)), None)
        if lim is None and not np.array_equal(
                w.astype(ml_dtypes.bfloat16).astype(np.float32), w):
            lim = CHAIN_F32_REL
        if lim is None and not np.array_equal(g, w):
            bad.append(f"{k}: {np.mean(g != w):.4%} differ")
        elif lim is not None and rel_err(g, w) > lim:
            bad.append(f"{k}: rel {rel_err(g, w):.3e} > {lim}")
    assert not bad, "\n".join(bad)


PIECES = ("attn:", "rglru:", "moe:", "ffn:", "embed", "head", "loss")


def check_pieces(readings, bar: float) -> float:
    """The largest share beyond one bf16 ulp over the pieces' bf16
    gradients in ``readings`` (``PIECES``: attention's projections, core
    and out-projection, the RG-LRU's and the MoE's pieces, the FFNs, the
    embedding, head and loss, each on the reference's own input); asserts
    it is within ``bar``."""
    worst, bad = 0.0, []
    for r in readings:
        for blk in r.blocks:
            if blk.kind.startswith(PIECES) and blk.bf16:
                far = shares(blk.got, blk.want)[1]
                worst = max(worst, far)
                if far > bar:
                    bad.append(f"{blk.name}: {far:.4%} beyond an ulp")
    assert not bad, "\n".join(bad)
    return worst


@functools.lru_cache(maxsize=None)
def reading_grad(arch: str, dtype: str, seed: int) -> Reading:
    return read_grad(Pair.of(arch, dtype), seed)


@functools.lru_cache(maxsize=None)
def reading_decode(arch: str, dtype: str, seed: int) -> Reading:
    return read_decode(Pair.of(arch, dtype), seed)


def _print(tag, arch, dtype, readings, chain_rel=False):
    for seed, r in zip(SEEDS, readings):
        for blk in r.blocks:
            d, f = shares(blk.got, blk.want)
            print(f"{tag}{arch} {dtype} seed {seed} {blk.name:12s} "
                  f"{blk.kind:18s} differ {d:.4%} far {f:.4%} "
                  f"rel {rel_err(blk.got, blk.want):.3e}")
        for k, (g, w) in r.scalars.items():
            if np.ndim(g):
                print(f"{tag}{arch} {dtype} seed {seed} {k} equal "
                      f"{np.mean(g == w):.4%}")
            else:
                print(f"{tag}{arch} {dtype} seed {seed} {k} {g!r} {w!r} "
                      f"|d| {abs(g - w):.3e}")
        for k, (g, w) in r.chain.items():
            print(f"{tag}{arch} {dtype} seed {seed} chain {k} differ "
                  f"{np.mean(g != w):.4%} rel {rel_err(g, w):.3e}")
    for k, (d, f, e) in sorted(by_kind(readings).items()):
        print(f"{tag}{arch} {dtype} max over seeds {k:18s} differ "
              f"{d:.4%} far {f:.4%} rel {e:.3e}")


def main(archs: Optional[List[str]] = None) -> None:
    """Print every block's reading, forward, backward (``grad``) and
    decode, over ``SEEDS`` in both dtypes; ``--bounds`` prints each
    kind's bound instead, as the test files hold them."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from repro.models import registry as R_R
    torch.set_num_threads(1)
    archs = list(archs or [])
    want_bounds = "--bounds" in archs
    if "--row-parallel" in archs:
        import jax
        for arch in [a for a in archs if not a.startswith("--")] or DENSE:
            pair = Pair.of(arch, "bfloat16")
            with jax.default_device(jax.devices("cpu")[0]), torch.no_grad():
                rs = [read_row_parallel(pair, s) for s in SEEDS]
            for k in rs[0]:
                print(f"row-parallel {arch} bfloat16 {k:24s} far "
                      f"{max(r[k][0] for r in rs):.4%} rel "
                      f"{max(r[k][1] for r in rs):.3e}")
        return
    archs = [a for a in archs if a != "--bounds"]
    for arch in archs or R_R.ARCH_IDS:
        for dtype in DTYPES:
            pair = Pair.of(arch, dtype)
            for tag, fn in (("", read), ("grad ", read_grad),
                            ("decode ", read_decode)):
                readings = [fn(pair, s) for s in SEEDS]
                if want_bounds:
                    b = bounds_of(readings, dtype)
                    if dtype == "float32" and tag:
                        b = compact(b)
                    print(f"{tag}{arch!r} {dtype!r}: {{")
                    for k, v in b.items():
                        print(f"    {k!r}: {v!r},")
                    print("},")
                else:
                    _print(tag, arch, dtype, readings)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(sys.argv[1:])

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

``PYTHONPATH=src python tests/_torch_blocks.py [arch ...]`` prints every
block's reading over ``SEEDS`` in both dtypes, and each block kind's
largest (the numbers behind the bounds of ``tests/test_torch_blocks*.py``).
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


class Block(NamedTuple):
    name: str           # where: "embed", "L1", "L1.mixer", "dec0.cross", ...
    kind: str           # what: "embed", "layer:attn", "attn:core:flash", ...
    got: np.ndarray     # the port's output, f32
    want: np.ndarray    # the reference's, f32


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

    def _attn_parts(self, p, h, pos, kind, causal=True, kv=None):
        """``layers.multihead_attention``'s pieces: (q, k, v after rope,
        the core's output (B, S, H, hd), the out-projection's output)."""
        import jax
        import jax.numpy as jnp
        from repro.kernels import ops as R_K
        from repro.models import layers as R_L
        cfg = self.r_cfg
        spec = self.spec(kind, causal)
        hd, g = cfg.resolved_head_dim, cfg.q_per_kv
        src = h if kv is None else kv
        q = jnp.einsum("bsd,dhk->bshk", h, p["wq"])
        k = jnp.einsum("bsd,dhk->bshk", src, p["wk"])
        v = jnp.einsum("bsd,dhk->bshk", src, p["wv"])
        if kv is None:
            q = R_L.apply_rope(q, pos, cfg.rope_theta)
            k = R_L.apply_rope(k, pos, cfg.rope_theta)
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
        core = core.reshape(b, s, cfg.n_heads, hd)
        return q, k, v, core, jnp.einsum("bshk,hkd->bsd", core, p["wo"])

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

        def combine(left, right):
            return left[0] + right[0], jnp.exp(right[0]) * left[1] + right[1]

        _, hs = jax.lax.associative_scan(combine, (log_a, b), axis=1)
        y = (g * hs).astype(h.dtype) @ p["w_out"]
        return xr.astype(jnp.float32), log_a, b, hs, g, y

    def _moe_parts(self, p, h):
        """``moe.moe_ffn``'s pieces on (B, S, D): (router logits, gates,
        expert ids, the routed combine, the shared experts' output or
        None)."""
        import jax
        import jax.numpy as jnp
        from repro.models import moe as R_M
        cfg, m = self.r_cfg, self.r_cfg.moe
        xt = h.reshape(-1, h.shape[-1])
        logits = xt.astype(jnp.float32) @ p["router"]
        gates, eids, _ = R_M.route(cfg, p["router"], xt)
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
        y = jnp.sum((out[slots] * w[:, None]).reshape(t, m.top_k, -1),
                    axis=1)
        shared = None
        if m.n_shared_experts:
            sp = p["shared"]
            shared = (act(xt @ sp["w_gate"]) * (xt @ sp["w_up"])
                      ) @ sp["w_down"]
        return logits, gates, eids, y, shared

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


def main(archs: Optional[List[str]] = None) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from repro.models import registry as R_R
    torch.set_num_threads(1)
    for arch in archs or R_R.ARCH_IDS:
        for dtype in DTYPES:
            pair = Pair.of(arch, dtype)
            readings = [read(pair, s) for s in SEEDS]
            for seed, r in zip(SEEDS, readings):
                for blk in r.blocks:
                    d, f = shares(blk.got, blk.want)
                    print(f"{arch} {dtype} seed {seed} {blk.name:12s} "
                          f"{blk.kind:18s} differ {d:.4%} far {f:.4%} "
                          f"rel {rel_err(blk.got, blk.want):.3e}")
                for k, (g, w) in r.scalars.items():
                    if np.ndim(g):
                        print(f"{arch} {dtype} seed {seed} {k} equal "
                              f"{np.mean(g == w):.4%}")
                    else:
                        print(f"{arch} {dtype} seed {seed} {k} {g!r} {w!r} "
                              f"|d| {abs(g - w):.3e}")
                for k, (g, w) in r.chain.items():
                    print(f"{arch} {dtype} seed {seed} chain {k} differ "
                          f"{np.mean(g != w):.4%}")
            for k, (d, f, e) in sorted(by_kind(readings).items()):
                print(f"{arch} {dtype} max over seeds {k:18s} differ "
                      f"{d:.4%} far {f:.4%} rel {e:.3e}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(sys.argv[1:])

"""Mamba-2 (SSD — state-space duality) block (the port of
``repro.models.ssm``).

Training/prefill uses the chunked dual form: the quadratic attention-like
product inside each chunk goes through ``kernels.ops.ssd_chunk_diff`` (the
CUDA kernel on the card, its plain version on the CPU), and the running
state crosses chunks in a Python loop (the JAX package's ``lax.scan``).
Decode is the O(1)-per-token recurrent update (``init_ssm_cache``,
``ssm_decode_step``), state in f32.  Single B/C group (n_groups = 1),
scalar-per-head A, depthwise causal conv over [x, B, C].  ``ssm_axes``
gives the logical-axes tree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops as K
from repro_torch.models.layers import (_dense_init, _device, _dtype, silu,
                                       silu_f32)

Params = Dict[str, Any]


def _dims(cfg: ModelConfig) -> Tuple[SSMConfig, int, int]:
    s = cfg.ssm or SSMConfig()
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    return s, d_in, n_heads


def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    s, d_in, H = _dims(cfg)
    d = cfg.d_model
    dt = _dtype(cfg)
    conv_dim = d_in + 2 * s.d_state
    dev = _device(gen)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # fused in_proj -> [z (d_in), x (d_in), B (N), C (N), dt (H)]
        "w_in": _dense_init(gen, (d, 2 * d_in + 2 * s.d_state + H), d, dt),
        "conv_w": _dense_init(gen, (s.conv_width, conv_dim), s.conv_width,
                              dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), 0.01, **f32).expm1().log(),
        "norm": torch.zeros((d_in,), **f32),
        "w_out": _dense_init(gen, (d_in, d), d_in, dt),
    }


def ssm_axes(cfg: ModelConfig) -> Params:
    return {"w_in": ("embed", "ssm_inner"), "conv_w": (None, "ssm_inner"),
            "conv_b": ("ssm_inner",), "A_log": (None,), "D": (None,),
            "dt_bias": (None,), "norm": ("ssm_inner",),
            "w_out": ("ssm_inner", "embed")}


def _split_in(cfg: ModelConfig, h: torch.Tensor):
    s, d_in, H = _dims(cfg)
    return torch.split(h, [d_in, d_in, s.d_state, s.d_state, H], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None, f32_out: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv along time, then SiLU -> (out, new tail).
    x (B, S, C), w (W, C).  Zeros stand before the first step, or, in
    decode, ``tail`` (B, W-1, C): the last W-1 inputs, returned updated.
    Every op rounds to x's dtype, as the reference's does; with
    ``f32_out`` the SiLU's last product stays f32 (``layers.silu_f32``;
    ``rglru._conv`` says where the compiled reference leaves it so)."""
    W = w.shape[0]
    if tail is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = xp[:, 0:x.shape[1], :] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    new_tail = xp[:, -(W - 1):, :] if W > 1 else None
    return (silu_f32 if f32_out else silu)(out + b), new_tail


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    yf = y.float() * silu(z.float())
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * (1.0 + scale)).to(y.dtype)


def ssm_forward(cfg: ModelConfig, p: Params,
                x_res: torch.Tensor) -> torch.Tensor:
    """Chunked SSD over a full sequence.  x_res: (B, S, D) -> (B, S, D)."""
    s, d_in, H = _dims(cfg)
    Bsz, S, _ = x_res.shape
    Q = min(s.chunk_size, S)
    if S % Q:
        raise ValueError(f"ssm_forward: seq {S} is not divisible by chunk "
                         f"{Q}")
    nc = S // Q
    P_ = s.head_dim
    N = s.d_state

    h = x_res @ p["w_in"]
    z, xin, Bm, Cm, dt = _split_in(cfg, h)
    conv_out, _ = _causal_conv(torch.cat([xin, Bm, Cm], dim=-1),
                               p["conv_w"], p["conv_b"])
    xin, Bm, Cm = torch.split(conv_out, [d_in, N, N], dim=-1)

    A = -torch.exp(p["A_log"])                                # (H,) negative
    dtv = F.softplus(dt.float() + p["dt_bias"])               # (B, S, H)
    xh = xin.reshape(Bsz, S, H, P_).float()
    xbar = xh * dtv[..., None]
    loga = (dtv * A).reshape(Bsz, nc, Q, H)
    cum = torch.cumsum(loga, dim=2)                           # (B, nc, Q, H)

    Bc = Bm.float().reshape(Bsz, nc, Q, N)
    Cc = Cm.float().reshape(Bsz, nc, Q, N)
    xc = xbar.reshape(Bsz, nc, Q, H, P_)

    # ---- intra-chunk (quadratic dual form), through the kernel ----
    # head-major (G, H, Q, .) views of the (B, nc, Q, H, .) tensors, G =
    # batch * n_chunks; the output comes back in xc's layout
    G = Bsz * nc
    y_k = K.ssd_chunk_diff(Bc.reshape(G, Q, N), Cc.reshape(G, Q, N),
                           cum.reshape(G, Q, H).transpose(1, 2),
                           xc.reshape(G, Q, H, P_).transpose(1, 2))
    y_intra = y_k.transpose(1, 2).reshape(Bsz, nc, Q, H, P_)

    # ---- chunk boundary states + inter-chunk pass ----
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B, nc, Q, H)
    chunk_state = torch.einsum("bckn,bckh,bckhp->bchpn", Bc, decay_to_end,
                               xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B, nc, H)
    carry = torch.zeros((Bsz, H, P_, N), dtype=torch.float32,
                        device=x_res.device)
    prev = []                           # the state BEFORE each chunk
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, torch.exp(cum),
                           prev_states)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P_) + p["D"][:, None] * xh
    y = _gated_norm(y.reshape(Bsz, S, d_in), z, p["norm"], cfg.norm_eps)
    # y is f32, so the out-projection runs in f32, as the reference's
    # f32 @ bf16 promotes
    return (y @ p["w_out"].float()).to(x_res.dtype)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device=None) -> Params:
    """Decode state: the f32 SSM state (B, H, P, N) and the conv's last
    W-1 inputs (B, W-1, d_in + 2N) in ``dtype``, all zeros."""
    s, d_in, H = _dims(cfg)
    return {
        "state": torch.zeros((batch, H, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
        "conv_tail": torch.zeros((batch, s.conv_width - 1,
                                  d_in + 2 * s.d_state), dtype=dtype,
                                 device=device),
    }


def ssm_decode_step(cfg: ModelConfig, p: Params, cache: Params,
                    x_res: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One recurrent step.  x_res (B, 1, D) -> (out (B, 1, D), cache), the
    new state and conv tail written into ``cache``'s tensors in place."""
    s, d_in, H = _dims(cfg)
    Bsz = x_res.shape[0]
    P_ = s.head_dim
    N = s.d_state

    h = x_res @ p["w_in"]
    z, xin, Bm, Cm, dt = _split_in(cfg, h)
    conv_out, new_tail = _causal_conv(torch.cat([xin, Bm, Cm], dim=-1),
                                      p["conv_w"], p["conv_b"],
                                      tail=cache["conv_tail"])
    xin, Bm, Cm = torch.split(conv_out, [d_in, N, N], dim=-1)

    A = -torch.exp(p["A_log"])
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])             # (B, H)
    a = torch.exp(dtv * A)                                        # (B, H)
    xh = xin[:, 0].reshape(Bsz, H, P_).float()
    Bv = Bm[:, 0].float()                                         # (B, N)
    Cv = Cm[:, 0].float()
    state = (cache["state"] * a[:, :, None, None]
             + torch.einsum("bhp,bn,bh->bhpn", xh, Bv, dtv))
    y = torch.einsum("bn,bhpn->bhp", Cv, state) + p["D"][:, None] * xh
    y = _gated_norm(y.reshape(Bsz, 1, d_in), z, p["norm"], cfg.norm_eps)
    cache["state"].copy_(state)
    cache["conv_tail"].copy_(new_tail)
    # y is f32: the out-projection runs in f32, as in ssm_forward
    return (y @ p["w_out"].float()).to(x_res.dtype), cache

"""The moe family's backward, block by block against the JAX package as it
compiles it (grok-1-314b, kimi-k2-1t-a32b; the harness is
``tests/_torch_blocks.py``, the readings as in
``tests/test_torch_blocks_grad.py``).

Repaired here beside the dense family's rules: the gates' gradient sums
each choice's products over D add by add in bf16 (``moe.routed_experts``
through ``layers.broadcast_mul``); the MoE's four users of its input (the
router, the dispatch, the shared expert's two projections) meet as
``jax.vjp`` adds them, every partial sum rounded (``fan(round_last=)``).
Largest share beyond one bf16 ulp over seeds 5-7, before -> after, the
MoE layer (``ffn:moe``) on the reference's input: kimi's ``w_gate``
gradient 23.9 % -> 0.0015 % and its input gradient 29.1 % -> 0.061 %
(grok 24.2 % -> 0.03 %, 31.6 % -> 0.42 %); the gates' gradient 47.7-53.1
% -> 0-0.39 %; flash's key and value gradients 7.6-8.5 % -> 0.01 %.  The
router's f32 gradient reads up to 5.1 % beyond a bf16 ulp (``rel_err``
1e-4 of its rms: f32 sums of a few flipped bf16 inputs).  kimi's whole
model at token seed 7 is within the shared tolerance against the
compiled reference (``tests/test_torch_moe.py``).
"""
import pytest

from _torch_blocks import (DTYPES, SEEDS, check_bounds, check_chain,
                           check_pieces, reading_grad)
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b")
PIECE_BAR = 0.01
CHAIN = {}
BOUNDS = {
    "grok-1-314b": {
        "bfloat16": {
            "attn:core:dk": ("shares", 0.00033, 0.0002, 0.000122, 0.0),
            "attn:core:dq": ("shares", 0.00051, 0.0002, 0.000305, 0.0),
            "attn:core:dv": ("shares", 0.00033, 0.00033, 0.000122, 0.000122),
            "attn:out:dcore": ("shares", 0.00036, 0.0002, 0.000153, 0.0),
            "attn:out:dwo": ("shares", 0.0003, 0.0002, 9.16e-05, 0.0),
            "attn:qkv:dh": ("shares", 0.0013, 0.00036, 0.000854, 0.000153),
            "attn:qkv:dwk": ("shares", 0.00057, 0.0002, 0.000366, 0.0),
            "attn:qkv:dwq": ("shares", 0.0013, 0.00039, 0.000854, 0.000183),
            "attn:qkv:dwv": ("shares", 0.00033, 0.0002, 0.000122, 0.0),
            "embed:dtable": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "ffn:moe:dh": ("shares", 0.012, 0.0064, 0.008, 0.00421),
            "ffn:moe:dmoe.router":
                ("shares", None, 0.077, 0.954, 0.0508, 0.0063, 0.00419),
            "ffn:moe:dmoe.w_down":
                ("shares", 0.00099, 0.00032, 0.000656, 0.000118),
            "ffn:moe:dmoe.w_gate":
                ("shares", 0.0014, 0.00049, 0.0009, 0.000286),
            "ffn:moe:dmoe.w_up": ("shares", 0.0021, 0.00077, 0.0014, 0.000507),
            "half:attn:dattn.wk": ("shares", 0.13, 0.024, 0.0835, 0.0159),
            "half:attn:dattn.wo":
                ("shares", 0.0096, 0.0013, 0.00638, 0.000809),
            "half:attn:dattn.wq": ("shares", 0.02, 0.0028, 0.013, 0.00186),
            "half:attn:dattn.wv": ("shares", 0.052, 0.0095, 0.0344, 0.00629),
            "half:attn:dln1":
                ("shares", None, 0.088, 1.0, 0.0586, 0.0054, 0.00358),
            "half:attn:dx": ("shares", 0.025, 0.0084, 0.0162, 0.00555),
            "half:moe:dln2":
                ("shares", None, 0.059, 0.965, 0.0391, 0.0053, 0.00353),
            "half:moe:dmoe.router":
                ("shares", None, 0.087, 0.973, 0.0576, 0.0049, 0.00322),
            "half:moe:dmoe.w_down":
                ("shares", 0.014, 0.0024, 0.00918, 0.00154),
            "half:moe:dmoe.w_gate":
                ("shares", 0.0099, 0.0019, 0.00658, 0.00124),
            "half:moe:dmoe.w_up": ("shares", 0.0094, 0.0016, 0.00623, 0.00105),
            "half:moe:dx": ("shares", 0.007, 0.0029, 0.00464, 0.00189),
            "head:dfinal_norm":
                ("shares", None, 0.0059, 0.863, 0.00391, 0.0026, 0.00168),
            "head:dtable": ("shares", 0.00057, 0.00027, 0.00037, 6.87e-05),
            "head:dx": ("shares", 0.002, 0.00054, 0.00131, 0.000336),
            "layer:attn+moe:dattn.wk": ("shares", 0.7, 0.25, 0.464, 0.161),
            "layer:attn+moe:dattn.wo": ("shares", 0.23, 0.047, 0.149, 0.0311),
            "layer:attn+moe:dattn.wq": ("shares", 0.43, 0.11, 0.282, 0.0731),
            "layer:attn+moe:dattn.wv": ("shares", 0.61, 0.19, 0.402, 0.126),
            "layer:attn+moe:dln1":
                ("shares", None, 0.48, 1.0, 0.316, 0.017, 0.011),
            "layer:attn+moe:dln2":
                ("shares", None, 0.17, 1.0, 0.113, 0.0078, 0.00517),
            "layer:attn+moe:dmoe.router":
                ("shares", None, 0.21, 1.0, 0.139, 0.0071, 0.00472),
            "layer:attn+moe:dmoe.w_down":
                ("shares", 0.082, 0.017, 0.0544, 0.0107),
            "layer:attn+moe:dmoe.w_gate":
                ("shares", 0.065, 0.014, 0.0433, 0.0091),
            "layer:attn+moe:dmoe.w_up":
                ("shares", 0.054, 0.0099, 0.0356, 0.00658),
            "layer:attn+moe:dx": ("shares", 0.24, 0.092, 0.155, 0.061),
            "loss:dlogits":
                ("shares", None, 0.0002, 0.925, 0.0, 3.2e-05, 2.08e-05),
            "mixer:attn:dattn.wk": ("shares", 0.075, 0.014, 0.05, 0.00867),
            "mixer:attn:dattn.wo": ("shares", 0.009, 0.0017, 0.00597, 0.00107),
            "mixer:attn:dattn.wq": ("shares", 0.02, 0.0031, 0.0132, 0.00201),
            "mixer:attn:dattn.wv": ("shares", 0.052, 0.0096, 0.0344, 0.00635),
            "mixer:attn:dh": ("shares", 0.04, 0.016, 0.0263, 0.0104),
            "model:dblocks.p0.attn.wk":
                ("shares", None, 0.7, 0.772, 0.461, 0.091, 0.0601),
            "model:dblocks.p0.attn.wo": ("shares", 0.99, 0.48, 0.658, 0.318),
            "model:dblocks.p0.attn.wq":
                ("shares", None, 0.64, 0.746, 0.423, 0.069, 0.046),
            "model:dblocks.p0.attn.wv":
                ("shares", None, 0.56, 0.7, 0.367, 0.081, 0.0536),
            "model:dblocks.p0.ln1":
                ("shares", None, 0.6, 1.0, 0.395, 0.029, 0.0189),
            "model:dblocks.p0.ln2":
                ("shares", None, 0.3, 1.0, 0.195, 0.016, 0.0105),
            "model:dblocks.p0.moe.router":
                ("shares", None, None, 1.0, 0.664, 0.063, 0.0416),
            "model:dblocks.p0.moe.w_down":
                ("shares", None, 0.51, 0.674, 0.337, 0.21, 0.14),
            "model:dblocks.p0.moe.w_gate":
                ("shares", None, 0.57, 0.708, 0.377, 0.19, 0.124),
            "model:dblocks.p0.moe.w_up":
                ("shares", None, 0.55, 0.697, 0.362, 0.14, 0.0877),
            "model:dembed.table": ("shares", 0.76, 0.11, 0.506, 0.0676),
            "model:dfinal_norm":
                ("shares", None, 0.0002, 1.0, 0.0, 0.0035, 0.00232),
            "moe:experts:dgates": ("shares", 0.0059, 0.0059, 0.00391, 0.00391),
            "moe:experts:dw_down":
                ("shares", 0.00081, 0.00033, 0.000538, 0.000126),
            "moe:experts:dw_gate":
                ("shares", 0.0007, 0.0003, 0.000465, 9.92e-05),
            "moe:experts:dw_up":
                ("shares", 0.00059, 0.00026, 0.000385, 5.72e-05),
            "moe:experts:dxt": ("shares", 0.0013, 0.00042, 0.000854, 0.000214),
            "moe:gates:dlogits":
                ("shares", None, 0.0002, 0.74, 0.0, 8.3e-07, 5.53e-07),
            "moe:router:dh": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "moe:router:drouter": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "model:loss": ("abs", 0.0029, 0.00189),
        },
        "float32": {
            "model:loss": ("abs", 2e-06, 9.54e-07),
            "*": ("rel", 3.8e-05, 2.49e-05),
        },
    },
    "kimi-k2-1t-a32b": {
        "bfloat16": {
            "attn:core:dk": ("shares", 0.00033, 0.00033, 0.000122, 0.000122),
            "attn:core:dq": ("shares", 0.00054, 0.0002, 0.000336, 0.0),
            "attn:core:dv": ("shares", 0.00033, 0.0002, 0.000122, 0.0),
            "attn:out:dcore": ("shares", 0.00036, 0.0002, 0.000153, 0.0),
            "attn:out:dwo": ("shares", 0.00031, 0.0002, 0.000107, 0.0),
            "attn:qkv:dh": ("shares", 0.0018, 0.00069, 0.00116, 0.000458),
            "attn:qkv:dwk": ("shares", 0.00074, 0.0002, 0.000488, 0.0),
            "attn:qkv:dwq": ("shares", 0.0013, 0.00039, 0.000854, 0.000183),
            "attn:qkv:dwv": ("shares", 0.00033, 0.0002, 0.000122, 0.0),
            "embed:dtable": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "ffn:mlp:dh": ("shares", 0.006, 0.0025, 0.00394, 0.00165),
            "ffn:mlp:dmlp.w_down":
                ("shares", 0.0039, 0.0011, 0.00258, 0.000702),
            "ffn:mlp:dmlp.w_gate":
                ("shares", 0.0013, 0.00043, 0.000839, 0.000229),
            "ffn:mlp:dmlp.w_up": ("shares", 0.004, 0.0022, 0.00264, 0.00143),
            "ffn:moe:dh": ("shares", 0.0016, 0.00092, 0.00101, 0.00061),
            "ffn:moe:dmoe.router":
                ("shares", None, 0.0002, 0.891, 0.0, 2.1e-06, 1.35e-06),
            "ffn:moe:dmoe.shared.w_down":
                ("shares", 0.0039, 0.00087, 0.00259, 0.00058),
            "ffn:moe:dmoe.shared.w_gate":
                ("shares", 0.0027, 0.00054, 0.00177, 0.000336),
            "ffn:moe:dmoe.shared.w_up":
                ("shares", 0.0036, 0.00065, 0.00238, 0.000427),
            "ffn:moe:dmoe.w_down":
                ("shares", 0.00065, 0.00025, 0.000427, 4.58e-05),
            "ffn:moe:dmoe.w_gate":
                ("shares", 0.00038, 0.00022, 0.000175, 1.53e-05),
            "ffn:moe:dmoe.w_up":
                ("shares", 0.0004, 0.00022, 0.000198, 1.53e-05),
            "half:attn:dattn.wk": ("shares", 0.089, 0.016, 0.0593, 0.0103),
            "half:attn:dattn.wo":
                ("shares", 0.0027, 0.00043, 0.00179, 0.000229),
            "half:attn:dattn.wq": ("shares", 0.011, 0.002, 0.00674, 0.00127),
            "half:attn:dattn.wv": ("shares", 0.0097, 0.0023, 0.00641, 0.00153),
            "half:attn:dln1":
                ("shares", None, 0.065, 0.996, 0.043, 0.0035, 0.00232),
            "half:attn:dx": ("shares", 0.012, 0.0033, 0.00754, 0.00217),
            "half:mlp:dln2":
                ("shares", None, 0.024, 0.969, 0.0156, 0.0019, 0.00125),
            "half:mlp:dmlp.w_down": ("shares", 0.0054, 0.002, 0.0036, 0.00127),
            "half:mlp:dmlp.w_gate":
                ("shares", 0.0034, 0.00062, 0.00226, 0.000412),
            "half:mlp:dmlp.w_up":
                ("shares", 0.0045, 0.0013, 0.00296, 0.000824),
            "half:mlp:dx": ("shares", 0.0043, 0.0014, 0.00281, 0.000916),
            "half:moe:dln2":
                ("shares", None, 0.018, 0.953, 0.0117, 0.0026, 0.00169),
            "half:moe:dmoe.router":
                ("shares", None, 0.028, 0.945, 0.0186, 0.0018, 0.00117),
            "half:moe:dmoe.shared.w_down":
                ("shares", 0.0083, 0.0021, 0.00552, 0.0014),
            "half:moe:dmoe.shared.w_gate":
                ("shares", 0.0065, 0.0018, 0.0043, 0.00119),
            "half:moe:dmoe.shared.w_up":
                ("shares", 0.0067, 0.0025, 0.00446, 0.00162),
            "half:moe:dmoe.w_down":
                ("shares", 0.0022, 0.00035, 0.00142, 0.000145),
            "half:moe:dmoe.w_gate":
                ("shares", 0.0032, 0.00066, 0.00209, 0.000435),
            "half:moe:dmoe.w_up":
                ("shares", 0.0018, 0.00033, 0.00118, 0.00013),
            "half:moe:dx": ("shares", 0.005, 0.0023, 0.00333, 0.00153),
            "head:dfinal_norm":
                ("shares", None, 0.0002, 0.852, 0.0, 5.8e-05, 3.83e-05),
            "head:dtable": ("shares", 0.00027, 0.0002, 6.87e-05, 0.0),
            "head:dx": ("shares", 0.00036, 0.0002, 0.000153, 0.0),
            "layer:attn+moe:dattn.wk": ("shares", 0.71, 0.24, 0.467, 0.156),
            "layer:attn+moe:dattn.wo": ("shares", 0.26, 0.054, 0.167, 0.0358),
            "layer:attn+moe:dattn.wq": ("shares", 0.41, 0.11, 0.272, 0.0686),
            "layer:attn+moe:dattn.wv": ("shares", 0.59, 0.18, 0.389, 0.115),
            "layer:attn+moe:dln1":
                ("shares", None, 0.39, 1.0, 0.258, 0.015, 0.00997),
            "layer:attn+moe:dln2":
                ("shares", None, 0.11, 1.0, 0.0703, 0.0061, 0.00405),
            "layer:attn+moe:dmoe.router":
                ("shares", None, 0.13, 0.995, 0.082, 0.0077, 0.00513),
            "layer:attn+moe:dmoe.shared.w_down":
                ("shares", 0.11, 0.023, 0.071, 0.0149),
            "layer:attn+moe:dmoe.shared.w_gate":
                ("shares", 0.075, 0.014, 0.05, 0.00879),
            "layer:attn+moe:dmoe.shared.w_up":
                ("shares", 0.07, 0.014, 0.0466, 0.00888),
            "layer:attn+moe:dmoe.w_down":
                ("shares", 0.076, 0.015, 0.0503, 0.00971),
            "layer:attn+moe:dmoe.w_gate":
                ("shares", 0.061, 0.013, 0.0406, 0.00813),
            "layer:attn+moe:dmoe.w_up":
                ("shares", 0.049, 0.011, 0.0322, 0.00719),
            "layer:attn+moe:dx": ("shares", 0.21, 0.073, 0.135, 0.0486),
            "layer:attn:dattn.wk": ("shares", 0.57, 0.17, 0.375, 0.112),
            "layer:attn:dattn.wo": ("shares", 0.093, 0.016, 0.0616, 0.0106),
            "layer:attn:dattn.wq": ("shares", 0.28, 0.06, 0.186, 0.0397),
            "layer:attn:dattn.wv": ("shares", 0.48, 0.14, 0.316, 0.0895),
            "layer:attn:dln1":
                ("shares", None, 0.43, 1.0, 0.285, 0.013, 0.00825),
            "layer:attn:dln2":
                ("shares", None, 0.036, 0.992, 0.0234, 0.0029, 0.00193),
            "layer:attn:dmlp.w_down": ("shares", 0.026, 0.0051, 0.017, 0.0034),
            "layer:attn:dmlp.w_gate":
                ("shares", 0.021, 0.0045, 0.0136, 0.00294),
            "layer:attn:dmlp.w_up": ("shares", 0.017, 0.0026, 0.011, 0.00172),
            "layer:attn:dx": ("shares", 0.17, 0.061, 0.107, 0.0405),
            "loss:dlogits":
                ("shares", None, 0.0002, 0.92, 0.0, 2.7e-05, 1.75e-05),
            "mixer:attn:dattn.wk": ("shares", 0.038, 0.0093, 0.0248, 0.00616),
            "mixer:attn:dattn.wo":
                ("shares", 0.0027, 0.00045, 0.00179, 0.000244),
            "mixer:attn:dattn.wq":
                ("shares", 0.0035, 0.00074, 0.0023, 0.000488),
            "mixer:attn:dattn.wv":
                ("shares", 0.0033, 0.00039, 0.0022, 0.000183),
            "mixer:attn:dh": ("shares", 0.0072, 0.0034, 0.00479, 0.00223),
            "model:dblocks.p0.attn.wk":
                ("shares", None, 0.6, 0.732, 0.4, 0.05, 0.0333),
            "model:dblocks.p0.attn.wo": ("shares", 0.89, 0.38, 0.587, 0.248),
            "model:dblocks.p0.attn.wq":
                ("shares", None, 0.52, 0.686, 0.344, 0.052, 0.0343),
            "model:dblocks.p0.attn.wv": ("shares", 0.99, 0.47, 0.658, 0.313),
            "model:dblocks.p0.ln1":
                ("shares", None, 0.54, 1.0, 0.355, 0.019, 0.0126),
            "model:dblocks.p0.ln2":
                ("shares", None, 0.024, 1.0, 0.0156, 0.0077, 0.00509),
            "model:dblocks.p0.moe.router":
                ("shares", None, 0.91, 1.0, 0.604, 0.043, 0.0286),
            "model:dblocks.p0.moe.shared.w_down":
                ("shares", 0.8, 0.31, 0.53, 0.204),
            "model:dblocks.p0.moe.shared.w_gate":
                ("shares", 0.83, 0.34, 0.551, 0.223),
            "model:dblocks.p0.moe.shared.w_up":
                ("shares", 0.83, 0.34, 0.551, 0.223),
            "model:dblocks.p0.moe.w_down":
                ("shares", 0.79, 0.31, 0.526, 0.206),
            "model:dblocks.p0.moe.w_gate": ("shares", 0.86, 0.36, 0.569, 0.24),
            "model:dblocks.p0.moe.w_up": ("shares", 0.84, 0.35, 0.554, 0.228),
            "model:dembed.table": ("shares", 0.91, 0.096, 0.603, 0.0639),
            "model:dfinal_norm":
                ("shares", None, 0.0002, 1.0, 0.0, 0.0029, 0.00193),
            "model:dprelude.0.attn.wk":
                ("shares", None, 0.74, 0.795, 0.493, 0.068, 0.045),
            "model:dprelude.0.attn.wo":
                ("shares", None, 0.55, 0.702, 0.365, 0.074, 0.0492),
            "model:dprelude.0.attn.wq":
                ("shares", None, 0.69, 0.766, 0.457, 0.068, 0.0453),
            "model:dprelude.0.attn.wv":
                ("shares", None, 0.65, 0.75, 0.428, 0.058, 0.0385),
            "model:dprelude.0.ln1":
                ("shares", None, 0.77, 1.0, 0.512, 0.031, 0.0201),
            "model:dprelude.0.ln2":
                ("shares", None, 0.26, 1.0, 0.172, 0.013, 0.00846),
            "model:dprelude.0.mlp.w_down":
                ("shares", None, 0.53, 0.692, 0.35, 0.07, 0.0466),
            "model:dprelude.0.mlp.w_gate":
                ("shares", None, 0.6, 0.728, 0.397, 0.075, 0.0495),
            "model:dprelude.0.mlp.w_up":
                ("shares", None, 0.58, 0.717, 0.381, 0.076, 0.0506),
            "moe:experts:dgates": ("shares", 0.0059, 0.0002, 0.00391, 0.0),
            "moe:experts:dw_down":
                ("shares", 0.00077, 0.00026, 0.000511, 5.34e-05),
            "moe:experts:dw_gate":
                ("shares", 0.00052, 0.00024, 0.00032, 3.81e-05),
            "moe:experts:dw_up":
                ("shares", 0.00039, 0.00022, 0.000183, 1.53e-05),
            "moe:experts:dxt":
                ("shares", 0.00054, 0.00042, 0.000336, 0.000214),
            "moe:gates:dlogits":
                ("shares", None, 0.0002, 0.717, 0.0, 8.7e-07, 5.8e-07),
            "moe:router:dh": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "moe:router:drouter": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "moe:shared:dw_down":
                ("shares", 0.0036, 0.00054, 0.00235, 0.000336),
            "moe:shared:dw_gate": ("shares", 0.00045, 0.0002, 0.000244, 0.0),
            "moe:shared:dw_up": ("shares", 0.003, 0.00054, 0.00195, 0.000336),
            "moe:shared:dxt": ("shares", 0.0012, 0.00054, 0.000793, 0.000336),
            "model:loss": ("abs", 0.0024, 0.00155),
        },
        "float32": {
            "model:loss": ("abs", 3e-06, 1.91e-06),
            "*": ("rel", 4e-05, 2.66e-05),
        },
    },
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_hold_to_the_reference(arch, dtype, seed):
    """Every block's pullback of a seeded cotangent on the reference's own
    input from ``seed``, and the whole model's loss and gradients (a kind
    "model:d<leaf>" per leaf, against ``jax.value_and_grad(compute_loss)``):
    bf16 to each kind's bound in ``BOUNDS``, f32 to its ``rel_err`` bound
    ("*")."""
    pytest.importorskip("jax")
    check_bounds(reading_grad(arch, dtype, seed), BOUNDS[arch][dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_chained_pullbacks_are_the_model(arch, dtype):
    """The reference's jitted block pullbacks, chained from the loss down,
    against its own ``jax.value_and_grad(compute_loss)``, leaf by leaf:
    a bf16 leaf's bits, an f32 leaf's within sum order
    (``_torch_blocks.CHAIN_F32_REL``), but where ``CHAIN`` names a bound
    (see the module docstring)."""
    pytest.importorskip("jax")
    check_chain(reading_grad(arch, dtype, SEEDS[0]),
                CHAIN.get((arch, dtype), {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_pieces_are_sum_order(arch):
    """Each piece's pullback on the reference's own input (attention's
    projections, core and out-projection, the RG-LRU's and the MoE's
    pieces, the FFN, the embedding, head and loss) is within ``PIECE_BAR``
    beyond one bf16 ulp in every bf16 gradient over seeds 5-7: what the
    compositions (mixer, halves, layer, model) read beyond that is the
    pieces' sum-order flips carried through each other."""
    pytest.importorskip("jax")
    worst = check_pieces([reading_grad(arch, "bfloat16", s) for s in SEEDS],
                         PIECE_BAR)
    print(f"{arch}: pieces at most {worst:.4%} beyond an ulp")

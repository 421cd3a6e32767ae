"""The backward of the families whose scanned group holds more than one
layer, block by block against the JAX package as it compiles it
(gemma2-2b, recurrentgemma-2b; the harness is ``tests/_torch_blocks.py``,
the readings as in ``tests/test_torch_blocks_grad.py``), and the RG-LRU
under ``jax.checkpoint``.

Repaired here beside the dense family's rules: the RG-LRU conv's and the
SSM conv's weight and bias gradients sum over (B, S) add by add in bf16,
in XLA's windows (``layers.broadcast_mul``/``broadcast_add``).  Largest
share beyond one bf16 ulp over seeds 5-7, before -> after: the conv's
``conv_w`` and ``conv_b`` gradients 56.3 % and 59.0 % -> 0.10 % and 0.39
%, its input and ``w_rec`` gradients 31.7-31.9 % -> 0.03 %; the RG-LRU
mixer's input gradient 17.0 % -> 0.47 %; flash's key and value gradients
7.8-7.9 % -> 0.02 %; the MLP's ``w_gate`` 30.9-31.3 % -> 0.02 %; the
RG-LRU layer's input gradient 33.0 % -> 8.5 %.  Pieces within 1.2 %
(gemma2's f32 final norm); compositions more, as in the dense family.

The chain criterion is not met inside a group: the reference's jitted
pullbacks of gemma2's and recurrentgemma's in-group layers, chained,
differ from its own ``value_and_grad`` there (``CHAIN``: ``rel_err`` up
to 4.0e-2 and 6.0e-1 on seed 5, the embedding 0.10 and 0.09), where the
group's last layer, the head and, in the forward, every layer match.
One jitted pullback of the model's whole ``lax.scan`` stretch, chained
the same way, misses as much at seeds 5 and 7 and matches at seed 6, so
the miss is not where the blocks are cut; its cause is not known
(``PERF.md`` §7).  These bounds record it; they are not a parity claim.
"""
import numpy as np
import pytest

import functools

from _torch_blocks import (DTYPES, SEEDS, Pair, check_bounds, check_chain,
                           check_pieces, inputs, reading_grad)
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCHS = ("gemma2-2b", "recurrentgemma-2b")
PIECE_BAR = 0.01
CHAIN = {
    ("gemma2-2b", "bfloat16"): {
        "L0.": 0.061,  # measured 0.0401
        "L1.": 0.03,  # measured 0.0194
        "embed": 0.15,  # measured 0.0998
        "final_norm": 2.3e-05,  # measured 1.52e-05
    },
    ("recurrentgemma-2b", "bfloat16"): {
        "L0.": 0.32,  # measured 0.211
        "L1.": 0.9,  # measured 0.599
        "embed": 0.14,  # measured 0.0925
    },
}
BOUNDS = {
    "gemma2-2b": {
        "bfloat16": {
            "attn:core:dk": ("shares", 0.00025, 0.00025, 4.07e-05, 4.07e-05),
            "attn:core:dq": ("shares", 0.00047, 0.0002, 0.000264, 0.0),
            "attn:core:dv": ("shares", 0.00033, 0.00025, 0.000122, 4.07e-05),
            "attn:out:dcore": ("shares", 0.00035, 0.0002, 0.000142, 0.0),
            "attn:out:dwo": ("shares", 0.0003, 0.0002, 9.16e-05, 0.0),
            "attn:qkv:dh": ("shares", 0.00031, 0.00025, 0.000102, 4.07e-05),
            "attn:qkv:dwk": ("shares", 0.00036, 0.0002, 0.000153, 0.0),
            "attn:qkv:dwq": ("shares", 0.00034, 0.0002, 0.000137, 0.0),
            "attn:qkv:dwv": ("shares", 0.0003, 0.0002, 9.16e-05, 0.0),
            "embed:dtable": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "ffn:mlp:dh": ("shares", 0.0022, 0.00074, 0.00142, 0.000488),
            "ffn:mlp:dmlp.w_down":
                ("shares", 0.0022, 0.0005, 0.00146, 0.000298),
            "ffn:mlp:dmlp.w_gate":
                ("shares", 0.0017, 0.00041, 0.00108, 0.000206),
            "ffn:mlp:dmlp.w_up":
                ("shares", 0.0017, 0.00045, 0.00113, 0.000244),
            "half:attn:dattn.wk": ("shares", 0.77, 0.29, 0.513, 0.188),
            "half:attn:dattn.wo": ("shares", 0.26, 0.05, 0.167, 0.0331),
            "half:attn:dattn.wq": ("shares", 0.66, 0.21, 0.435, 0.137),
            "half:attn:dattn.wv": ("shares", 0.63, 0.2, 0.415, 0.131),
            "half:attn:dln1":
                ("shares", None, 0.44, 1.0, 0.293, 0.015, 0.00959),
            "half:attn:dln1_post":
                ("shares", None, 0.16, 1.0, 0.102, 0.0051, 0.00339),
            "half:attn:dx": ("shares", None, 0.2, 0.995, 0.132, 0.027, 0.0175),
            "half:attn_local:dattn.wk": ("shares", 0.62, 0.2, 0.411, 0.128),
            "half:attn_local:dattn.wo":
                ("shares", 0.14, 0.024, 0.0919, 0.0159),
            "half:attn_local:dattn.wq": ("shares", 0.48, 0.13, 0.32, 0.0838),
            "half:attn_local:dattn.wv": ("shares", 0.55, 0.16, 0.362, 0.106),
            "half:attn_local:dln1":
                ("shares", None, 0.39, 1.0, 0.258, 0.014, 0.00894),
            "half:attn_local:dln1_post":
                ("shares", None, 0.065, 1.0, 0.043, 0.0044, 0.00293),
            "half:attn_local:dx": ("shares", 0.35, 0.17, 0.228, 0.111),
            "half:mlp:dln2":
                ("shares", None, 0.041, 1.0, 0.0273, 0.0026, 0.00169),
            "half:mlp:dln2_post":
                ("shares", None, 0.0059, 1.0, 0.00391, 0.0017, 0.00112),
            "half:mlp:dmlp.w_down":
                ("shares", 0.009, 0.0013, 0.00594, 0.000854),
            "half:mlp:dmlp.w_gate": ("shares", 0.058, 0.0097, 0.0383, 0.00641),
            "half:mlp:dmlp.w_up": ("shares", 0.051, 0.007, 0.034, 0.00464),
            "half:mlp:dx": ("shares", 0.013, 0.006, 0.00842, 0.00399),
            "head:dfinal_norm":
                ("shares", None, 0.018, 0.895, 0.0117, 0.0028, 0.00182),
            "head:dtable": ("shares", 0.00098, 0.0003, 0.000648, 9.16e-05),
            "head:dx": ("shares", 0.0029, 0.00059, 0.00189, 0.000387),
            "layer:attn:dattn.wk":
                ("shares", None, 0.57, 0.712, 0.374, 0.046, 0.0305),
            "layer:attn:dattn.wo": ("shares", 0.91, 0.39, 0.606, 0.259),
            "layer:attn:dattn.wq":
                ("shares", None, 0.54, 0.698, 0.357, 0.052, 0.0345),
            "layer:attn:dattn.wv":
                ("shares", None, 0.49, 0.671, 0.326, 0.063, 0.0418),
            "layer:attn:dln1":
                ("shares", None, 0.81, 1.0, 0.539, 0.023, 0.0147),
            "layer:attn:dln1_post":
                ("shares", None, 0.47, 1.0, 0.312, 0.016, 0.0106),
            "layer:attn:dln2":
                ("shares", None, 0.49, 1.0, 0.324, 0.017, 0.0111),
            "layer:attn:dln2_post":
                ("shares", None, 0.39, 1.0, 0.254, 0.01, 0.00665),
            "layer:attn:dmlp.w_down": ("shares", 0.7, 0.25, 0.462, 0.161),
            "layer:attn:dmlp.w_gate": ("shares", 0.81, 0.32, 0.537, 0.208),
            "layer:attn:dmlp.w_up": ("shares", 0.75, 0.28, 0.498, 0.183),
            "layer:attn:dx": ("shares", None, 0.52, 1.0, 0.342, 0.049, 0.0322),
            "layer:attn_local:dattn.wk":
                ("shares", None, 0.57, 0.709, 0.375, 0.049, 0.0326),
            "layer:attn_local:dattn.wo": ("shares", 0.9, 0.38, 0.595, 0.247),
            "layer:attn_local:dattn.wq":
                ("shares", None, 0.52, 0.691, 0.346, 0.046, 0.0306),
            "layer:attn_local:dattn.wv":
                ("shares", None, 0.55, 0.701, 0.363, 0.057, 0.0375),
            "layer:attn_local:dln1":
                ("shares", None, 0.81, 1.0, 0.535, 0.039, 0.0254),
            "layer:attn_local:dln1_post":
                ("shares", None, 0.41, 1.0, 0.273, 0.014, 0.00905),
            "layer:attn_local:dln2":
                ("shares", None, 0.41, 1.0, 0.27, 0.012, 0.00775),
            "layer:attn_local:dln2_post":
                ("shares", None, 0.32, 1.0, 0.211, 0.009, 0.00596),
            "layer:attn_local:dmlp.w_down":
                ("shares", 0.56, 0.17, 0.368, 0.113),
            "layer:attn_local:dmlp.w_gate":
                ("shares", 0.66, 0.22, 0.438, 0.146),
            "layer:attn_local:dmlp.w_up": ("shares", 0.6, 0.19, 0.395, 0.125),
            "layer:attn_local:dx": ("shares", 0.91, 0.56, 0.606, 0.368),
            "loss:dlogits":
                ("shares", None, 0.0002, 0.884, 0.0, 1.8e-05, 1.17e-05),
            "mixer:attn:dattn.wk": ("shares", 0.16, 0.031, 0.105, 0.0204),
            "mixer:attn:dattn.wo": ("shares", 0.072, 0.013, 0.0475, 0.00821),
            "mixer:attn:dattn.wq": ("shares", 0.13, 0.026, 0.0863, 0.0172),
            "mixer:attn:dattn.wv": ("shares", 0.11, 0.018, 0.0729, 0.0116),
            "mixer:attn:dh": ("shares", 0.12, 0.047, 0.0781, 0.031),
            "mixer:attn_local:dattn.wk":
                ("shares", 0.064, 0.0087, 0.0423, 0.0058),
            "mixer:attn_local:dattn.wo":
                ("shares", 0.036, 0.0041, 0.024, 0.00273),
            "mixer:attn_local:dattn.wq":
                ("shares", 0.058, 0.009, 0.0382, 0.00595),
            "mixer:attn_local:dattn.wv":
                ("shares", 0.042, 0.0059, 0.0275, 0.00388),
            "mixer:attn_local:dh": ("shares", 0.045, 0.018, 0.0299, 0.0117),
            "model:dblocks.p0.attn.wk":
                ("shares", None, 0.78, 0.808, 0.517, 0.071, 0.0469),
            "model:dblocks.p0.attn.wo":
                ("shares", None, 0.69, 0.77, 0.459, 0.087, 0.0574),
            "model:dblocks.p0.attn.wq":
                ("shares", None, 0.77, 0.803, 0.507, 0.066, 0.044),
            "model:dblocks.p0.attn.wv":
                ("shares", None, 0.75, 0.793, 0.497, 0.085, 0.0563),
            "model:dblocks.p0.ln1":
                ("shares", None, 0.99, 1.0, 0.66, 0.045, 0.0294),
            "model:dblocks.p0.ln1_post":
                ("shares", None, 0.8, 1.0, 0.531, 0.028, 0.0186),
            "model:dblocks.p0.ln2":
                ("shares", None, 0.96, 1.0, 0.637, 0.034, 0.0221),
            "model:dblocks.p0.ln2_post":
                ("shares", None, 0.71, 1.0, 0.473, 0.025, 0.0166),
            "model:dblocks.p0.mlp.w_down":
                ("shares", None, 0.64, 0.749, 0.421, 0.089, 0.0593),
            "model:dblocks.p0.mlp.w_gate":
                ("shares", None, 0.7, 0.775, 0.465, 0.084, 0.0556),
            "model:dblocks.p0.mlp.w_up":
                ("shares", None, 0.67, 0.763, 0.444, 0.087, 0.0578),
            "model:dblocks.p1.attn.wk":
                ("shares", None, 0.71, 0.779, 0.471, 0.05, 0.0333),
            "model:dblocks.p1.attn.wo":
                ("shares", None, 0.56, 0.711, 0.37, 0.066, 0.0439),
            "model:dblocks.p1.attn.wq":
                ("shares", None, 0.68, 0.767, 0.451, 0.056, 0.0367),
            "model:dblocks.p1.attn.wv":
                ("shares", None, 0.63, 0.737, 0.414, 0.06, 0.0395),
            "model:dblocks.p1.ln1":
                ("shares", None, 0.95, 1.0, 0.629, 0.033, 0.0215),
            "model:dblocks.p1.ln1_post":
                ("shares", None, 0.63, 1.0, 0.418, 0.024, 0.0155),
            "model:dblocks.p1.ln2":
                ("shares", None, 0.87, 1.0, 0.574, 0.03, 0.0195),
            "model:dblocks.p1.ln2_post":
                ("shares", None, 0.59, 1.0, 0.391, 0.022, 0.0142),
            "model:dblocks.p1.mlp.w_down":
                ("shares", None, 0.59, 0.723, 0.389, 0.084, 0.0558),
            "model:dblocks.p1.mlp.w_gate":
                ("shares", None, 0.66, 0.756, 0.435, 0.14, 0.09),
            "model:dblocks.p1.mlp.w_up":
                ("shares", None, 0.61, 0.733, 0.402, 0.067, 0.0443),
            "model:dembed.table": ("shares", 0.8, 0.26, 0.53, 0.168),
            "model:dfinal_norm":
                ("shares", None, 0.077, 1.0, 0.0508, 0.0075, 0.00495),
            "model:loss": ("abs", 0.00063, 0.000416),
        },
        "float32": {
            "model:loss": ("abs", 2e-06, 9.54e-07),
            "*": ("rel", 2.7e-05, 1.75e-05),
        },
    },
    "recurrentgemma-2b": {
        "bfloat16": {
            "attn:core:dk": ("shares", 0.00037, 0.00029, 0.000163, 8.14e-05),
            "attn:core:dq": ("shares", 0.00051, 0.0002, 0.000305, 0.0),
            "attn:core:dv": ("shares", 0.00037, 0.00037, 0.000163, 0.000163),
            "attn:out:dcore": ("shares", 0.00029, 0.0002, 8.14e-05, 0.0),
            "attn:out:dwo": ("shares", 0.00034, 0.0002, 0.000137, 0.0),
            "attn:qkv:dh": ("shares", 0.00045, 0.00037, 0.000244, 0.000163),
            "attn:qkv:dwk": ("shares", 0.00039, 0.0002, 0.000183, 0.0),
            "attn:qkv:dwq": ("shares", 0.00071, 0.00027, 0.000473, 6.1e-05),
            "attn:qkv:dwv": ("shares", 0.00027, 0.0002, 6.1e-05, 0.0),
            "embed:dtable": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "ffn:mlp:dh": ("shares", 0.0029, 0.0011, 0.00193, 0.000692),
            "ffn:mlp:dmlp.w_down":
                ("shares", 0.0036, 0.0011, 0.0024, 0.000687),
            "ffn:mlp:dmlp.w_gate":
                ("shares", 0.0022, 0.00041, 0.00142, 0.000206),
            "ffn:mlp:dmlp.w_up":
                ("shares", 0.0026, 0.00056, 0.00168, 0.000351),
            "half:attn_local:dattn.wk": ("shares", 0.25, 0.051, 0.161, 0.0336),
            "half:attn_local:dattn.wo":
                ("shares", 0.093, 0.014, 0.0616, 0.00902),
            "half:attn_local:dattn.wq": ("shares", 0.2, 0.036, 0.128, 0.0237),
            "half:attn_local:dattn.wv":
                ("shares", 0.13, 0.025, 0.0808, 0.0164),
            "half:attn_local:dln1":
                ("shares", None, 0.15, 1.0, 0.0938, 0.0091, 0.00601),
            "half:attn_local:dx": ("shares", 0.99, 0.012, 0.657, 0.00779),
            "half:mlp:dln2":
                ("shares", None, 0.018, 0.988, 0.0117, 0.0024, 0.00158),
            "half:mlp:dmlp.w_down":
                ("shares", 0.0024, 0.0004, 0.00157, 0.000198),
            "half:mlp:dmlp.w_gate":
                ("shares", 0.0041, 0.0011, 0.00269, 0.000694),
            "half:mlp:dmlp.w_up":
                ("shares", 0.0017, 0.00033, 0.00108, 0.00013),
            "half:mlp:dx": ("shares", 0.0027, 0.0012, 0.00177, 0.000753),
            "half:rglru:dln1":
                ("shares", None, 0.071, 1.0, 0.0469, 0.0044, 0.00293),
            "half:rglru:drglru.b_a":
                ("shares", None, 0.0002, 1.0, 0.0, 0.0034, 0.00222),
            "half:rglru:drglru.b_x":
                ("shares", None, 0.0002, 0.992, 0.0, 0.00062, 0.000411),
            "half:rglru:drglru.conv_b":
                ("shares", 0.024, 0.0059, 0.0156, 0.00391),
            "half:rglru:drglru.conv_w":
                ("shares", 0.025, 0.014, 0.0166, 0.00879),
            "half:rglru:drglru.lam":
                ("shares", None, 0.0002, 0.996, 0.0, 0.0029, 0.0019),
            "half:rglru:drglru.w_a":
                ("shares", 0.015, 0.0011, 0.0098, 0.000671),
            "half:rglru:drglru.w_gelu":
                ("shares", 0.012, 0.002, 0.00768, 0.00127),
            "half:rglru:drglru.w_out":
                ("shares", 0.018, 0.0028, 0.0114, 0.00183),
            "half:rglru:drglru.w_rec":
                ("shares", 0.084, 0.014, 0.0556, 0.00909),
            "half:rglru:drglru.w_x":
                ("shares", 0.012, 0.00092, 0.00746, 0.00061),
            "half:rglru:dx": ("shares", 0.95, 0.0027, 0.63, 0.00177),
            "head:dfinal_norm":
                ("shares", None, 0.0002, 0.883, 0.0, 0.00064, 0.000421),
            "head:dtable": ("shares", 0.00028, 0.0002, 7.25e-05, 0.0),
            "head:dx": ("shares", 0.00045, 0.00025, 0.000244, 4.07e-05),
            "layer:attn_local:dattn.wk": ("shares", 0.93, 0.42, 0.62, 0.28),
            "layer:attn_local:dattn.wo": ("shares", 0.51, 0.14, 0.336, 0.091),
            "layer:attn_local:dattn.wq": ("shares", 0.8, 0.3, 0.533, 0.2),
            "layer:attn_local:dattn.wv": ("shares", 0.87, 0.36, 0.577, 0.234),
            "layer:attn_local:dln1":
                ("shares", None, 0.65, 1.0, 0.43, 0.02, 0.0133),
            "layer:attn_local:dln2":
                ("shares", None, 0.31, 1.0, 0.203, 0.01, 0.00662),
            "layer:attn_local:dmlp.w_down":
                ("shares", 0.47, 0.13, 0.31, 0.0854),
            "layer:attn_local:dmlp.w_gate":
                ("shares", 0.48, 0.14, 0.316, 0.0876),
            "layer:attn_local:dmlp.w_up": ("shares", 0.4, 0.11, 0.261, 0.0689),
            "layer:attn_local:dx":
                ("shares", None, 0.22, 0.996, 0.145, 0.033, 0.022),
            "layer:rglru:dln1":
                ("shares", None, 0.41, 1.0, 0.27, 0.009, 0.00594),
            "layer:rglru:dln2":
                ("shares", None, 0.16, 1.0, 0.102, 0.006, 0.00397),
            "layer:rglru:dmlp.w_down": ("shares", 0.32, 0.073, 0.209, 0.0485),
            "layer:rglru:dmlp.w_gate": ("shares", 0.33, 0.077, 0.214, 0.0507),
            "layer:rglru:dmlp.w_up": ("shares", 0.26, 0.055, 0.169, 0.0362),
            "layer:rglru:drglru.b_a":
                ("shares", None, 0.22, 1.0, 0.145, 0.023, 0.0151),
            "layer:rglru:drglru.b_x":
                ("shares", None, 0.23, 1.0, 0.152, 0.016, 0.0104),
            "layer:rglru:drglru.conv_b": ("shares", 0.54, 0.26, 0.355, 0.168),
            "layer:rglru:drglru.conv_w": ("shares", 0.74, 0.41, 0.49, 0.268),
            "layer:rglru:drglru.lam":
                ("shares", None, 0.25, 1.0, 0.164, 0.024, 0.016),
            "layer:rglru:drglru.w_a": ("shares", 0.52, 0.14, 0.343, 0.0929),
            "layer:rglru:drglru.w_gelu": ("shares", 0.58, 0.18, 0.386, 0.114),
            "layer:rglru:drglru.w_out": ("shares", 0.44, 0.12, 0.291, 0.0771),
            "layer:rglru:drglru.w_rec": ("shares", 0.8, 0.32, 0.531, 0.21),
            "layer:rglru:drglru.w_x": ("shares", 0.52, 0.14, 0.343, 0.093),
            "layer:rglru:dx":
                ("shares", None, 0.13, 0.985, 0.085, 0.032, 0.0212),
            "loss:dlogits":
                ("shares", None, 0.0002, 0.916, 0.0, 2.9e-05, 1.92e-05),
            "mixer:attn_local:dattn.wk":
                ("shares", 0.23, 0.053, 0.152, 0.0347),
            "mixer:attn_local:dattn.wo":
                ("shares", 0.055, 0.0077, 0.0363, 0.00508),
            "mixer:attn_local:dattn.wq":
                ("shares", 0.19, 0.035, 0.125, 0.0229),
            "mixer:attn_local:dattn.wv":
                ("shares", 0.11, 0.022, 0.0693, 0.0145),
            "mixer:attn_local:dh": ("shares", 0.11, 0.04, 0.0682, 0.0264),
            "mixer:rglru:dh": ("shares", 0.019, 0.0071, 0.0125, 0.00472),
            "mixer:rglru:drglru.b_a":
                ("shares", None, 0.0002, 1.0, 0.0, 0.0013, 0.000836),
            "mixer:rglru:drglru.b_x":
                ("shares", None, 0.0002, 0.977, 0.0, 0.00093, 0.000619),
            "mixer:rglru:drglru.conv_b":
                ("shares", 0.0059, 0.0059, 0.00391, 0.00391),
            "mixer:rglru:drglru.conv_w":
                ("shares", 0.012, 0.0088, 0.00781, 0.00586),
            "mixer:rglru:drglru.lam":
                ("shares", None, 0.0002, 1.0, 0.0, 0.0012, 0.000734),
            "mixer:rglru:drglru.w_a":
                ("shares", 0.013, 0.00081, 0.00833, 0.000534),
            "mixer:rglru:drglru.w_gelu":
                ("shares", 0.017, 0.0031, 0.0109, 0.00201),
            "mixer:rglru:drglru.w_out":
                ("shares", 0.017, 0.0031, 0.0113, 0.00204),
            "mixer:rglru:drglru.w_rec":
                ("shares", 0.05, 0.008, 0.0328, 0.00528),
            "mixer:rglru:drglru.w_x":
                ("shares", 0.0076, 0.0009, 0.00502, 0.000595),
            "model:dblocks.p0.ln1":
                ("shares", None, 0.63, 1.0, 0.414, 0.025, 0.0163),
            "model:dblocks.p0.ln2":
                ("shares", None, 0.49, 1.0, 0.324, 0.019, 0.0123),
            "model:dblocks.p0.mlp.w_down":
                ("shares", None, 0.73, 0.79, 0.486, 0.098, 0.065),
            "model:dblocks.p0.mlp.w_gate":
                ("shares", None, 0.79, 0.807, 0.521, 0.096, 0.0639),
            "model:dblocks.p0.mlp.w_up":
                ("shares", None, 0.75, 0.797, 0.499, 0.099, 0.0655),
            "model:dblocks.p0.rglru.b_a":
                ("shares", None, 0.99, 1.0, 0.656, 0.073, 0.0484),
            "model:dblocks.p0.rglru.b_x":
                ("shares", None, 0.85, 1.0, 0.562, 0.048, 0.0316),
            "model:dblocks.p0.rglru.conv_b":
                ("shares", None, 0.78, 0.77, 0.516, 0.048, 0.0319),
            "model:dblocks.p0.rglru.conv_w":
                ("shares", None, 0.88, 0.812, 0.584, 0.08, 0.0532),
            "model:dblocks.p0.rglru.lam":
                ("shares", None, None, 1.0, 0.664, 0.072, 0.0475),
            "model:dblocks.p0.rglru.w_a":
                ("shares", None, 0.78, 0.804, 0.52, 0.72, 0.475),
            "model:dblocks.p0.rglru.w_gelu":
                ("shares", None, 0.81, 0.817, 0.54, 0.12, 0.0774),
            "model:dblocks.p0.rglru.w_out":
                ("shares", None, 0.72, 0.785, 0.478, 0.15, 0.0952),
            "model:dblocks.p0.rglru.w_rec":
                ("shares", None, 0.84, 0.824, 0.557, 0.2, 0.129),
            "model:dblocks.p0.rglru.w_x":
                ("shares", None, 0.75, 0.795, 0.499, 0.51, 0.337),
            "model:dblocks.p1.ln1":
                ("shares", None, 0.41, 1.0, 0.273, 0.017, 0.0113),
            "model:dblocks.p1.ln2":
                ("shares", None, 0.2, 1.0, 0.133, 0.013, 0.00829),
            "model:dblocks.p1.mlp.w_down":
                ("shares", None, 0.7, 0.777, 0.464, 0.067, 0.0441),
            "model:dblocks.p1.mlp.w_gate":
                ("shares", None, 0.75, 0.795, 0.497, 0.083, 0.055),
            "model:dblocks.p1.mlp.w_up":
                ("shares", None, 0.71, 0.779, 0.472, 0.087, 0.0575),
            "model:dblocks.p1.rglru.b_a":
                ("shares", None, 0.92, 1.0, 0.613, 0.042, 0.0277),
            "model:dblocks.p1.rglru.b_x":
                ("shares", None, 0.78, 1.0, 0.52, 0.044, 0.029),
            "model:dblocks.p1.rglru.conv_b":
                ("shares", None, 0.75, 0.77, 0.496, 0.051, 0.0335),
            "model:dblocks.p1.rglru.conv_w":
                ("shares", None, 0.85, 0.806, 0.563, 0.084, 0.0558),
            "model:dblocks.p1.rglru.lam":
                ("shares", None, 0.88, 1.0, 0.582, 0.04, 0.0263),
            "model:dblocks.p1.rglru.w_a":
                ("shares", None, 0.73, 0.781, 0.485, 0.87, 0.579),
            "model:dblocks.p1.rglru.w_gelu":
                ("shares", None, 0.75, 0.797, 0.497, 0.15, 0.0993),
            "model:dblocks.p1.rglru.w_out":
                ("shares", None, 0.68, 0.768, 0.453, 0.14, 0.0873),
            "model:dblocks.p1.rglru.w_rec":
                ("shares", None, 0.77, 0.801, 0.51, 0.16, 0.101),
            "model:dblocks.p1.rglru.w_x":
                ("shares", None, 0.69, 0.767, 0.457, 0.59, 0.391),
            "model:dblocks.p2.attn.wk":
                ("shares", None, 0.83, 0.824, 0.547, 0.076, 0.0504),
            "model:dblocks.p2.attn.wo":
                ("shares", None, 0.67, 0.761, 0.443, 0.06, 0.0396),
            "model:dblocks.p2.attn.wq":
                ("shares", None, 0.8, 0.812, 0.531, 0.065, 0.043),
            "model:dblocks.p2.attn.wv":
                ("shares", None, 0.69, 0.769, 0.454, 0.053, 0.0349),
            "model:dblocks.p2.ln1":
                ("shares", None, 0.77, 1.0, 0.508, 0.024, 0.0154),
            "model:dblocks.p2.ln2":
                ("shares", None, 0.19, 1.0, 0.125, 0.013, 0.00839),
            "model:dblocks.p2.mlp.w_down":
                ("shares", None, 0.7, 0.774, 0.464, 0.082, 0.0542),
            "model:dblocks.p2.mlp.w_gate":
                ("shares", None, 0.76, 0.798, 0.502, 0.078, 0.0518),
            "model:dblocks.p2.mlp.w_up":
                ("shares", None, 0.72, 0.784, 0.475, 0.081, 0.0539),
            "model:dembed.table":
                ("shares", None, 0.25, 0.735, 0.163, 0.21, 0.139),
            "model:dfinal_norm":
                ("shares", None, 0.0002, 1.0, 0.0, 0.0069, 0.00457),
            "rglru:conv:dconv_b": ("shares", 0.0059, 0.0059, 0.00391, 0.00391),
            "rglru:conv:dconv_w":
                ("shares", 0.0015, 0.0015, 0.000977, 0.000977),
            "rglru:conv:dh": ("shares", 0.0026, 0.00043, 0.00169, 0.000224),
            "rglru:conv:dw_rec": ("shares", 0.0014, 0.00049, 0.00087, 0.00029),
            "rglru:gates:db_a":
                ("shares", None, 0.0002, 0.91, 0.0, 1.9e-06, 1.22e-06),
            "rglru:gates:db_x":
                ("shares", None, 0.0002, 0.902, 0.0, 2.4e-06, 1.56e-06),
            "rglru:gates:dlam":
                ("shares", None, 0.0002, 0.949, 0.0, 4.6e-06, 3.02e-06),
            "rglru:gates:dw_a": ("shares", 0.00051, 0.0002, 0.000305, 0.0),
            "rglru:gates:dw_x": ("shares", 0.00054, 0.0002, 0.000336, 0.0),
            "rglru:gates:dxr":
                ("shares", None, 0.0002, 0.667, 0.0, 1.9e-05, 1.25e-05),
            "rglru:gelu:dh": ("shares", 0.002, 0.00037, 0.00128, 0.000163),
            "rglru:gelu:dw_gelu":
                ("shares", 0.0016, 0.00025, 0.00102, 4.58e-05),
            "rglru:out:dg": ("shares", 0.00039, 0.00023, 0.000183, 2.03e-05),
            "rglru:out:dhs": ("shares", 0.00039, 0.00025, 0.000183, 4.07e-05),
            "rglru:out:dw_out": ("shares", 0.00034, 0.0002, 0.000137, 0.0),
            "rglru:scan:db":
                ("shares", None, 0.0002, 0.731, 0.0, 2e-06, 1.29e-06),
            "rglru:scan:dlog_a":
                ("shares", None, 0.0002, 0.848, 0.0, 3.7e-06, 2.44e-06),
            "model:loss": ("abs", 0.0018, 0.00117),
        },
        "float32": {
            "model:loss": ("abs", 2e-06, 9.54e-07),
            "*": ("rel", 5.6e-05, 3.67e-05),
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


def test_checkpointed_rglru_block_holds_to_jax_checkpoint():
    """The RG-LRU block of recurrentgemma's first layer under the port's
    ``transformer.remat_call`` (non-reentrant checkpointing) against the
    reference's block under ``jax.checkpoint``, each inside its package's
    value-and-gradient of a seeded weighting of the output, seeds 5-7: the
    loss and every gradient (the block's params and its input) held at
    the plain block's bound, the port's un-checkpointed block against the
    reference's (``_torch_blocks.bound`` of the plain pair's share beyond
    one bf16 ulp, leaf by leaf and seed by seed, and of its largest loss
    gap relative to the loss over the seeds).  The reference's
    checkpointed forward keeps the conv's last product f32 and its
    recompute rounds it, so its own two losses differ; so do the port's
    (``rglru._conv``), where before they were the same bits.  Measured:
    every gradient reads the same share in both pairs (at most 0.42 %
    beyond an ulp, the input gradient at seed 7); the loss gaps 1.9e-5 to
    6.5e-4 of the loss checkpointed, 6.6e-6 to 5.1e-4 plain."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import torch
    from _torch_blocks import _flat, _np, _t, bound, shares
    from repro.models import rglru as R_RG
    from repro_torch.models import rglru as T_RG
    from repro_torch.models import transformer as T_T
    pair = Pair.of("recurrentgemma-2b", "bfloat16")
    cfg = pair.r_cfg
    lp, tlp, _, _ = pair.layers()[0]
    f = functools.partial(R_RG.rglru_forward, cfg)
    gaps = {False: [], True: []}
    for seed in SEEDS:
        tok, _, _ = inputs(pair, seed)
        w = np.random.default_rng(seed).normal(
            size=(len(tok), pair.seq, cfg.d_model)).astype(np.float32)

        def loss(p, h, ckpt):
            y = (jax.checkpoint(f) if ckpt else f)(p, h)
            return jnp.sum(y.astype(jnp.float32) * w)

        with jax.default_device(jax.devices("cpu")[0]):
            x = pair.embed(pair.params["embed"]["table"], jnp.asarray(tok),
                           None)
            h = pair.norm(x, lp["ln1"])
            ref = {c: jax.jit(jax.value_and_grad(
                functools.partial(loss, ckpt=c), argnums=(0, 1)))(
                    lp["rglru"], h) for c in (False, True)}
        assert float(ref[True][0]) != float(ref[False][0])
        far = {}
        for remat in (False, True):
            p = {k: v.detach().clone().requires_grad_()
                 for k, v in tlp["rglru"].items()}
            th = _t(h).requires_grad_()
            y = T_T.remat_call(remat, functools.partial(
                T_RG.rglru_forward, pair.t_cfg), p, th)
            tl = (y.float() * torch.from_numpy(w)).sum()
            grads = torch.autograd.grad(tl, list(p.values()) + [th])
            r_loss, (r_gp, r_gh) = ref[remat]
            gaps[remat].append(abs(float(tl.detach()) - float(r_loss))
                               / abs(float(r_loss)))
            want = dict(_flat(r_gp), h=r_gh)
            far[remat] = {k: shares(_np(g), _np(want[k]))[1]
                          for k, g in zip(list(p) + ["h"], grads)}
        for k in far[False]:
            print(f"seed {seed} {k}: far plain {far[False][k]:.4%} "
                  f"checkpointed {far[True][k]:.4%}")
            assert far[True][k] <= bound(far[False][k]), (seed, k)
    print(f"loss gaps over the loss: plain {gaps[False]}, checkpointed "
          f"{gaps[True]}")
    assert max(gaps[True]) <= bound(max(gaps[False]), 0.0), gaps

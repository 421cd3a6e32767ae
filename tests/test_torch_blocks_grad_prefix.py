"""The backward of the ssm, vlm and enc-dec families, block by block
against the JAX package as it compiles it (mamba2-2.7b, paligemma-3b,
seamless-m4t-medium; the harness is ``tests/_torch_blocks.py``, the
readings as in ``tests/test_torch_blocks_grad.py``; seamless's blocks are
the bodies of ``encdec.encode``'s and ``encdec.forward``'s scans, its
cross-attention and the encoder's final norm, and its chain takes the
encoder's cotangent from the reference's own decoder scan).

Largest share beyond one bf16 ulp over seeds 5-7, before -> after:
mamba2's SSM ``conv_w`` and ``conv_b`` gradients 53.8 % and 56.8 % ->
0.17 % and 0.35 % (the conv's sums, ``layers.broadcast_mul``), its input
and ``w_in`` gradients 22.0 % and 15.2 % -> 0.19 % and 0.15 %, the layer's
21.2 % -> 0.62 %, the whole model's worst leaf 55.6 % -> 36.3 %;
paligemma's and seamless's MLP ``w_gate`` 30.3-31.4 % -> 0.03 % and input
gradients 25.4-25.6 % -> 0.11-0.16 %; seamless's encoder layer 33.6 % ->
8.3 %, decoder layer 35.7 % -> 19.1 %.

The chain is the model's bits but for paligemma's first layer and
embedding (``CHAIN``: ``rel_err`` 3.2e-2 and 5.0e-2 on seed 5, cause not
known: the chain criterion is not met there, ``PERF.md`` §7), one of
mamba2's ``w_in`` gradient values (1.7e-4) and the f32 leaves' sum order.
"""
import pytest

from _torch_blocks import (DTYPES, SEEDS, check_bounds, check_chain,
                           check_pieces, reading_grad)
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCHS = ("mamba2-2.7b", "paligemma-3b", "seamless-m4t-medium")
PIECE_BAR = 0.01
CHAIN = {
    ("paligemma-3b", "bfloat16"): {
        "L0.": 0.048,  # measured 0.0319
        "embed": 0.075,  # measured 0.0495
    },
    ("mamba2-2.7b", "bfloat16"): {
        "L1.dssm.w_in": 0.00026,  # measured 0.000171
    },
}
BOUNDS = {
    "mamba2-2.7b": {
        "bfloat16": {
            "embed:dtable": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "head:dfinal_norm":
                ("shares", None, 0.0002, 0.891, 0.0, 0.00025, 0.000163),
            "head:dtable": ("shares", 0.0025, 0.00056, 0.00164, 0.000351),
            "head:dx": ("shares", 0.00033, 0.0002, 0.000122, 0.0),
            "layer:ssm:dln1":
                ("shares", None, 0.094, 0.992, 0.0625, 0.0047, 0.00313),
            "layer:ssm:dssm.A_log":
                ("shares", None, 0.0002, 1.0, 0.0, 0.00089, 0.00059),
            "layer:ssm:dssm.D":
                ("shares", None, 0.0002, 1.0, 0.0, 0.00025, 0.000163),
            "layer:ssm:dssm.conv_b":
                ("shares", 0.014, 0.014, 0.00868, 0.00868),
            "layer:ssm:dssm.conv_w":
                ("shares", 0.0098, 0.002, 0.00651, 0.0013),
            "layer:ssm:dssm.dt_bias":
                ("shares", None, 0.0002, 1.0, 0.0, 0.00047, 0.000308),
            "layer:ssm:dssm.norm":
                ("shares", None, 0.003, 0.982, 0.00195, 0.0016, 0.00102),
            "layer:ssm:dssm.w_in": ("shares", 0.017, 0.0032, 0.011, 0.00212),
            "layer:ssm:dssm.w_out":
                ("shares", 0.0086, 0.00049, 0.00568, 0.00029),
            "layer:ssm:dx": ("shares", 0.025, 0.0094, 0.0161, 0.00623),
            "loss:dlogits":
                ("shares", None, 0.0002, 0.927, 0.0, 3e-05, 1.97e-05),
            "mixer:ssm:dh": ("shares", 0.024, 0.0029, 0.0155, 0.00192),
            "mixer:ssm:dssm.A_log":
                ("shares", None, 0.0002, 1.0, 0.0, 0.00029, 0.000193),
            "mixer:ssm:dssm.D":
                ("shares", None, 0.0002, 1.0, 0.0, 0.00069, 0.000456),
            "mixer:ssm:dssm.conv_b":
                ("shares", 0.0053, 0.0053, 0.00347, 0.00347),
            "mixer:ssm:dssm.conv_w":
                ("shares", 0.0066, 0.0027, 0.00434, 0.00174),
            "mixer:ssm:dssm.dt_bias":
                ("shares", None, 0.094, 1.0, 0.0625, 0.00041, 0.000271),
            "mixer:ssm:dssm.norm":
                ("shares", None, 0.003, 0.984, 0.00195, 0.0039, 0.00259),
            "mixer:ssm:dssm.w_in": ("shares", 0.014, 0.0023, 0.0091, 0.00151),
            "mixer:ssm:dssm.w_out":
                ("shares", 0.0087, 0.00062, 0.00576, 0.000412),
            "model:dblocks.p0.ln1":
                ("shares", None, 0.55, 1.0, 0.363, 0.021, 0.0135),
            "model:dblocks.p0.ssm.A_log":
                ("shares", None, 0.47, 1.0, 0.312, 0.012, 0.00776),
            "model:dblocks.p0.ssm.D":
                ("shares", None, 0.33, 1.0, 0.219, 0.014, 0.00872),
            "model:dblocks.p0.ssm.conv_b": ("shares", 0.78, 0.5, 0.517, 0.33),
            "model:dblocks.p0.ssm.conv_w":
                ("shares", 0.83, 0.51, 0.547, 0.336),
            "model:dblocks.p0.ssm.dt_bias":
                ("shares", None, 0.43, 1.0, 0.281, 0.012, 0.00741),
            "model:dblocks.p0.ssm.norm":
                ("shares", None, 0.18, 1.0, 0.114, 0.029, 0.0192),
            "model:dblocks.p0.ssm.w_in": ("shares", 0.81, 0.33, 0.534, 0.215),
            "model:dblocks.p0.ssm.w_out": ("shares", 0.64, 0.22, 0.421, 0.143),
            "model:dembed.table": ("shares", 0.72, 0.063, 0.478, 0.0419),
            "model:dfinal_norm":
                ("shares", None, 0.0002, 1.0, 0.0, 0.0014, 0.000922),
            "model:loss": ("abs", 0.00012, 7.72e-05),
        },
        "float32": {
            "model:loss": ("abs", 3e-06, 1.91e-06),
            "*": ("rel", 2.7e-05, 1.78e-05),
        },
    },
    "paligemma-3b": {
        "bfloat16": {
            "attn:core:dk": ("shares", 0.0033, 0.0004, 0.00215, 0.000195),
            "attn:core:dq": ("shares", 0.00096, 0.0002, 0.000635, 0.0),
            "attn:core:dv": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "attn:out:dcore": ("shares", 0.0003, 0.0002, 9.77e-05, 0.0),
            "attn:out:dwo": ("shares", 0.00028, 0.0002, 7.63e-05, 0.0),
            "attn:qkv:dh": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "attn:qkv:dwk": ("shares", 0.00051, 0.0002, 0.000305, 0.0),
            "attn:qkv:dwq": ("shares", 0.00031, 0.0002, 0.000107, 0.0),
            "attn:qkv:dwv": ("shares", 0.00033, 0.0002, 0.000122, 0.0),
            "embed:dtable": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "ffn:mlp:dh": ("shares", 0.0045, 0.0017, 0.00298, 0.00107),
            "ffn:mlp:dmlp.w_down":
                ("shares", 0.00089, 0.00029, 0.000587, 8.39e-05),
            "ffn:mlp:dmlp.w_gate":
                ("shares", 0.00056, 0.00024, 0.000359, 3.81e-05),
            "ffn:mlp:dmlp.w_up":
                ("shares", 0.0016, 0.00056, 0.00104, 0.000351),
            "half:attn:dattn.wk": ("shares", 0.28, 0.061, 0.181, 0.0404),
            "half:attn:dattn.wo": ("shares", 0.092, 0.016, 0.0608, 0.0106),
            "half:attn:dattn.wq": ("shares", 0.13, 0.029, 0.0848, 0.0192),
            "half:attn:dattn.wv": ("shares", 0.14, 0.025, 0.088, 0.0161),
            "half:attn:dln1":
                ("shares", None, 0.15, 1.0, 0.0938, 0.0067, 0.00441),
            "half:attn:dx": ("shares", 0.041, 0.015, 0.0269, 0.01),
            "half:mlp:dln2":
                ("shares", None, 0.0059, 0.879, 0.00391, 0.0012, 0.000775),
            "half:mlp:dmlp.w_down":
                ("shares", 0.0012, 0.00033, 0.000763, 0.000122),
            "half:mlp:dmlp.w_gate":
                ("shares", 0.0014, 0.00032, 0.000877, 0.000114),
            "half:mlp:dmlp.w_up":
                ("shares", 0.00061, 0.00025, 0.000404, 4.58e-05),
            "half:mlp:dx": ("shares", 0.0016, 0.0006, 0.00103, 0.000391),
            "head:dfinal_norm":
                ("shares", None, 0.0002, 0.832, 0.0, 0.00027, 0.000175),
            "head:dtable": ("shares", 0.00024, 0.0002, 3.05e-05, 0.0),
            "head:dx": ("shares", 0.0005, 0.00025, 0.000293, 4.88e-05),
            "layer:attn:dattn.wk": ("shares", 0.82, 0.32, 0.541, 0.208),
            "layer:attn:dattn.wo": ("shares", 0.45, 0.12, 0.3, 0.0785),
            "layer:attn:dattn.wq": ("shares", 0.7, 0.24, 0.462, 0.159),
            "layer:attn:dattn.wv": ("shares", 0.71, 0.24, 0.468, 0.157),
            "layer:attn:dln1":
                ("shares", None, 0.52, 1.0, 0.344, 0.019, 0.0122),
            "layer:attn:dln2":
                ("shares", None, 0.23, 1.0, 0.148, 0.0062, 0.00411),
            "layer:attn:dmlp.w_down": ("shares", 0.34, 0.084, 0.223, 0.0557),
            "layer:attn:dmlp.w_gate": ("shares", 0.34, 0.086, 0.224, 0.0569),
            "layer:attn:dmlp.w_up": ("shares", 0.27, 0.061, 0.176, 0.0404),
            "layer:attn:dx": ("shares", 0.38, 0.16, 0.253, 0.104),
            "loss:dlogits":
                ("shares", None, 0.0002, 0.944, 0.0, 3.9e-05, 2.57e-05),
            "mixer:attn:dattn.wk": ("shares", 0.31, 0.073, 0.205, 0.0481),
            "mixer:attn:dattn.wo": ("shares", 0.091, 0.017, 0.0601, 0.0109),
            "mixer:attn:dattn.wq": ("shares", 0.14, 0.032, 0.0911, 0.0207),
            "mixer:attn:dattn.wv": ("shares", 0.091, 0.015, 0.0602, 0.00934),
            "mixer:attn:dh": ("shares", 0.11, 0.049, 0.0704, 0.0325),
            "model:dblocks.p0.attn.wk":
                ("shares", None, 0.72, 0.779, 0.479, 0.072, 0.0475),
            "model:dblocks.p0.attn.wo":
                ("shares", None, 0.58, 0.719, 0.383, 0.08, 0.0531),
            "model:dblocks.p0.attn.wq":
                ("shares", None, 0.71, 0.778, 0.471, 0.098, 0.0649),
            "model:dblocks.p0.attn.wv":
                ("shares", None, 0.6, 0.726, 0.397, 0.073, 0.0481),
            "model:dblocks.p0.ln1":
                ("shares", None, 0.8, 1.0, 0.529, 0.038, 0.0248),
            "model:dblocks.p0.ln2":
                ("shares", None, 0.33, 1.0, 0.217, 0.019, 0.0125),
            "model:dblocks.p0.mlp.w_down":
                ("shares", None, 0.52, 0.681, 0.341, 0.12, 0.0778),
            "model:dblocks.p0.mlp.w_gate":
                ("shares", None, 0.58, 0.718, 0.386, 0.19, 0.125),
            "model:dblocks.p0.mlp.w_up":
                ("shares", None, 0.55, 0.698, 0.361, 0.12, 0.0782),
            "model:dembed.table":
                ("shares", None, 0.051, 0.719, 0.0338, 0.3, 0.197),
            "model:dfinal_norm":
                ("shares", None, 0.012, 1.0, 0.00781, 0.0055, 0.00366),
            "model:loss": ("abs", 0.0033, 0.00219),
        },
        "float32": {
            "model:loss": ("abs", 2e-06, 9.54e-07),
            "*": ("rel", 3.2e-05, 2.08e-05),
        },
    },
    "seamless-m4t-medium": {
        "bfloat16": {
            "attn:core:dk": ("shares", 0.0011, 0.0002, 0.000732, 0.0),
            "attn:core:dq": ("shares", 0.00083, 0.0002, 0.000549, 0.0),
            "attn:core:dv": ("shares", 0.00045, 0.0002, 0.000244, 0.0),
            "attn:out:dcore": ("shares", 0.00045, 0.0002, 0.000244, 0.0),
            "attn:out:dwo": ("shares", 0.00027, 0.0002, 6.1e-05, 0.0),
            "attn:qkv:dh": ("shares", 0.0037, 0.0019, 0.00244, 0.00122),
            "attn:qkv:dkv": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "attn:qkv:dwk": ("shares", 0.0022, 0.00059, 0.00145, 0.000381),
            "attn:qkv:dwq": ("shares", 0.00025, 0.0002, 4.58e-05, 0.0),
            "attn:qkv:dwv": ("shares", 0.00027, 0.0002, 6.1e-05, 0.0),
            "cross:denc": ("shares", 0.063, 0.03, 0.0415, 0.0198),
            "cross:dhx": ("shares", 0.011, 0.0027, 0.00696, 0.00177),
            "cross:dwk": ("shares", 0.026, 0.0062, 0.0169, 0.00407),
            "cross:dwo": ("shares", 0.099, 0.027, 0.0658, 0.0179),
            "cross:dwq": ("shares", 0.019, 0.0036, 0.0122, 0.00238),
            "cross:dwv": ("shares", 0.095, 0.029, 0.0629, 0.019),
            "embed:dtable": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "enc_norm:denc_norm":
                ("shares", None, 0.0002, 0.754, 0.0, 7.6e-07, 5.06e-07),
            "enc_norm:dx": ("shares", 0.00045, 0.0002, 0.000244, 0.0),
            "ffn:mlp:dh": ("shares", 0.0067, 0.0025, 0.00446, 0.00165),
            "ffn:mlp:dmlp.w_down":
                ("shares", 0.0012, 0.0004, 0.00074, 0.000198),
            "ffn:mlp:dmlp.w_gate":
                ("shares", 0.0014, 0.00046, 0.000931, 0.000259),
            "ffn:mlp:dmlp.w_up": ("shares", 0.0024, 0.0014, 0.00156, 0.00087),
            "head:dfinal_norm":
                ("shares", None, 0.0059, 0.777, 0.00391, 0.00059, 0.00039),
            "head:dtable": ("shares", 0.00024, 0.0002, 3.43e-05, 0.0),
            "head:dx": ("shares", 0.00045, 0.0002, 0.000244, 0.0),
            "layer:dec:dattn.wk": ("shares", 0.94, 0.42, 0.622, 0.276),
            "layer:dec:dattn.wo": ("shares", 0.78, 0.3, 0.52, 0.195),
            "layer:dec:dattn.wq": ("shares", 0.91, 0.4, 0.605, 0.263),
            "layer:dec:dattn.wv": ("shares", 0.89, 0.38, 0.593, 0.25),
            "layer:dec:denc": ("shares", 0.86, 0.45, 0.568, 0.299),
            "layer:dec:dln1": ("shares", None, 0.69, 1.0, 0.457, 0.03, 0.0194),
            "layer:dec:dln2": ("shares", None, 0.5, 1.0, 0.328, 0.018, 0.0117),
            "layer:dec:dln_x":
                ("shares", None, 0.64, 1.0, 0.426, 0.018, 0.0119),
            "layer:dec:dmlp.w_down": ("shares", 0.81, 0.33, 0.534, 0.216),
            "layer:dec:dmlp.w_gate": ("shares", 0.83, 0.35, 0.552, 0.227),
            "layer:dec:dmlp.w_up": ("shares", 0.75, 0.29, 0.495, 0.187),
            "layer:dec:dx": ("shares", 0.57, 0.29, 0.375, 0.191),
            "layer:dec:dxattn.wk": ("shares", 0.97, 0.46, 0.646, 0.301),
            "layer:dec:dxattn.wo": ("shares", 0.83, 0.33, 0.55, 0.22),
            "layer:dec:dxattn.wq": ("shares", 0.94, 0.43, 0.626, 0.286),
            "layer:dec:dxattn.wv": ("shares", 0.93, 0.42, 0.615, 0.274),
            "layer:enc:dattn.wk": ("shares", 0.44, 0.13, 0.293, 0.0865),
            "layer:enc:dattn.wo": ("shares", 0.11, 0.028, 0.0671, 0.0186),
            "layer:enc:dattn.wq": ("shares", 0.35, 0.096, 0.228, 0.0639),
            "layer:enc:dattn.wv": ("shares", 0.22, 0.064, 0.144, 0.0423),
            "layer:enc:dln1": ("shares", None, 0.4, 1.0, 0.266, 0.018, 0.012),
            "layer:enc:dln2":
                ("shares", None, 0.059, 0.969, 0.0391, 0.004, 0.00262),
            "layer:enc:dmlp.w_down": ("shares", 0.044, 0.012, 0.029, 0.00763),
            "layer:enc:dmlp.w_gate": ("shares", 0.028, 0.0077, 0.0185, 0.0051),
            "layer:enc:dmlp.w_up": ("shares", 0.027, 0.0073, 0.0176, 0.00481),
            "layer:enc:dx": ("shares", 0.33, 0.13, 0.214, 0.0828),
            "loss:dlogits":
                ("shares", None, 0.0002, 0.883, 0.0, 2.6e-05, 1.68e-05),
            "mixer:dec:dattn.wk": ("shares", 0.043, 0.0095, 0.0286, 0.00633),
            "mixer:dec:dattn.wo": ("shares", 0.031, 0.005, 0.0204, 0.0033),
            "mixer:dec:dattn.wq": ("shares", 0.05, 0.012, 0.0332, 0.00739),
            "mixer:dec:dattn.wv": ("shares", 0.028, 0.0055, 0.0181, 0.00365),
            "mixer:dec:dh": ("shares", 0.077, 0.03, 0.0513, 0.0197),
            "mixer:enc:dattn.wk": ("shares", 0.025, 0.0056, 0.0163, 0.00369),
            "mixer:enc:dattn.wo":
                ("shares", 0.0012, 0.0004, 0.000748, 0.000198),
            "mixer:enc:dattn.wq": ("shares", 0.023, 0.0053, 0.015, 0.00348),
            "mixer:enc:dattn.wv":
                ("shares", 0.0024, 0.00094, 0.00159, 0.000626),
            "mixer:enc:dh": ("shares", 0.025, 0.0088, 0.0164, 0.00586),
            "model:ddecoder.attn.wk":
                ("shares", None, 0.9, 0.847, 0.597, 0.13, 0.0835),
            "model:ddecoder.attn.wo":
                ("shares", None, 0.72, 0.784, 0.48, 0.072, 0.0478),
            "model:ddecoder.attn.wq":
                ("shares", None, 0.89, 0.841, 0.588, 0.12, 0.0757),
            "model:ddecoder.attn.wv":
                ("shares", None, 0.75, 0.792, 0.499, 0.071, 0.047),
            "model:ddecoder.ln1":
                ("shares", None, 0.98, 1.0, 0.648, 0.059, 0.039),
            "model:ddecoder.ln2":
                ("shares", None, 0.68, 1.0, 0.453, 0.032, 0.0211),
            "model:ddecoder.ln_x":
                ("shares", None, None, 1.0, 0.676, 0.056, 0.0367),
            "model:ddecoder.mlp.w_down":
                ("shares", None, 0.81, 0.817, 0.54, 0.16, 0.105),
            "model:ddecoder.mlp.w_gate":
                ("shares", None, 0.86, 0.832, 0.569, 0.17, 0.11),
            "model:ddecoder.mlp.w_up":
                ("shares", None, 0.82, 0.821, 0.544, 0.16, 0.104),
            "model:ddecoder.xattn.wk":
                ("shares", None, 0.87, 0.837, 0.577, 0.13, 0.0844),
            "model:ddecoder.xattn.wo":
                ("shares", None, 0.72, 0.78, 0.474, 0.12, 0.0744),
            "model:ddecoder.xattn.wq":
                ("shares", None, 0.89, 0.843, 0.587, 0.14, 0.0867),
            "model:ddecoder.xattn.wv":
                ("shares", None, 0.71, 0.782, 0.473, 0.11, 0.0718),
            "model:dembed.table":
                ("shares", None, 0.29, 0.71, 0.193, 0.38, 0.25),
            "model:denc_norm":
                ("shares", None, 0.83, 1.0, 0.551, 0.031, 0.0206),
            "model:dencoder.attn.wk":
                ("shares", None, 0.89, 0.839, 0.587, 0.16, 0.105),
            "model:dencoder.attn.wo":
                ("shares", None, 0.77, 0.8, 0.509, 0.11, 0.0704),
            "model:dencoder.attn.wq":
                ("shares", None, 0.89, 0.845, 0.593, 0.18, 0.114),
            "model:dencoder.attn.wv":
                ("shares", None, 0.79, 0.813, 0.526, 0.11, 0.0695),
            "model:dencoder.ln1":
                ("shares", None, None, 1.0, 0.678, 0.056, 0.0373),
            "model:dencoder.ln2":
                ("shares", None, None, 1.0, 0.68, 0.07, 0.0462),
            "model:dencoder.mlp.w_down":
                ("shares", None, 0.84, 0.827, 0.559, 0.21, 0.135),
            "model:dencoder.mlp.w_gate":
                ("shares", None, 0.88, 0.834, 0.581, 0.22, 0.142),
            "model:dencoder.mlp.w_up":
                ("shares", None, 0.87, 0.833, 0.574, 0.19, 0.122),
            "model:dfinal_norm":
                ("shares", None, 0.071, 1.0, 0.0469, 0.012, 0.008),
            "model:loss": ("abs", 0.0019, 0.00122),
        },
        "float32": {
            "model:loss": ("abs", 2e-06, 9.54e-07),
            "*": ("rel", 3.3e-05, 2.16e-05),
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

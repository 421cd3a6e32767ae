"""The dense family's backward, block by block against the JAX package as
it compiles it (smollm-135m, smollm-360m, stablelm-1.6b; the harness is
``tests/_torch_blocks.py``), and the backward's rounding rules.

Each block of ``tests/test_torch_blocks.py`` is fed the reference's own
input and a cotangent drawn with numpy, and pulled back through the
reference's block under ``jax.jit(jax.vjp(...))`` and through the port's
with ``torch.autograd.grad``: its input gradient and every parameter
gradient are read with ``shares``.  Beside the layers, the layer's two
halves (cut at the residual sum that ``ln2`` reads) and the whole model
(``compute_loss``'s gradients, a kind "model:d<leaf>" per leaf).
``PYTHONPATH=src python tests/_torch_blocks.py ARCH`` prints every
reading.

What the harness found and the port now does as XLA compiles it
(``models/layers.py``, ``kernels/ops.py``): the activations' pullback is
``jax.vjp``'s op chain in bf16 (``silu``'s ``g * s + (x * g) * (s * (1 -
s))``, gelu's through ``tanh``); flash's GQA keys and values are summed
over each group add by add in bf16 (``ops.rounded_sum``, XLA's tree of
32-wide windows); a norm's users' cotangents meet in f32 before its f32
pullback (``rms_norm(held=)``, ``fan``), and ``ln2``'s input gradient is
rounded before the residual's joins it (``layers.round_grad``).  Largest
share beyond one bf16 ulp over seeds 5-7, before -> after: the MLP's
``w_gate`` gradient 24.5-24.8 % -> at most 0.06 %, its input gradient
20.4-20.9 % -> 0.03-0.14 %; flash's key and value gradients (smollm, 3
query heads a kv head) 4.3-4.8 % -> 0.01 %; the attention mixer's input
gradient 17.3-17.6 % -> 0.9-1.5 %; the layer's 27.3-28.8 % -> 6.5-14.6 %.
What remains is sum order: every piece on its own input is within 0.42 %
(``test_pieces_are_sum_order``), and a layer, or the whole model (46-52 %
of some leaf's values beyond an ulp, unchanged), adds up each piece's
flips (a weight's gradient sums over every position, near cancelling).
The f32 readings are sum order too (``rel_err`` up to 2.5e-5).

``BOUNDS``: per config and dtype; bf16 per block kind and gradient leaf,
("shares", bound on the differ share, bound on the share beyond one bf16
ulp, measured, measured), the bound 1.5 times the largest of seeds 5-7
and at least 0.02 % above it, rounded up; where a share reads above 2/3
its bound would hold nothing and is None, and the kind is held by
``rel_err`` too (two more entries, bound and measured, 1.5 times); f32
one ``rel_err`` bound for every block ("*", 1.5 times the largest) and
the loss's gap ("abs").
"""
import numpy as np
import pytest
import torch

from _torch_blocks import (DTYPES, SEEDS, check_bounds, check_chain,
                           check_pieces, reading_grad)
from test_torch_resume import _one_torch_thread  # noqa: F401

ARCHS = ("smollm-135m", "smollm-360m", "stablelm-1.6b")
PIECE_BAR = 0.01
CHAIN = {}
BOUNDS = {
    "smollm-135m": {
        "bfloat16": {
            "attn:core:dk": ("shares", 0.00033, 0.00033, 0.000122, 0.000122),
            "attn:core:dq": ("shares", 0.00049, 0.0002, 0.000285, 0.0),
            "attn:core:dv": ("shares", 0.00033, 0.00033, 0.000122, 0.000122),
            "attn:out:dcore": ("shares", 0.00033, 0.0002, 0.000122, 0.0),
            "attn:out:dwo": ("shares", 0.00034, 0.0002, 0.000136, 0.0),
            "attn:qkv:dh": ("shares", 0.0028, 0.00092, 0.00183, 0.00061),
            "attn:qkv:dwk": ("shares", 0.00029, 0.0002, 8.14e-05, 0.0),
            "attn:qkv:dwq": ("shares", 0.0031, 0.00074, 0.00206, 0.000488),
            "attn:qkv:dwv": ("shares", 0.00029, 0.0002, 8.14e-05, 0.0),
            "embed:dtable": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "ffn:mlp:dh": ("shares", 0.0014, 0.00057, 0.000895, 0.000366),
            "ffn:mlp:dmlp.w_down":
                ("shares", 0.0017, 0.00035, 0.00107, 0.000149),
            "ffn:mlp:dmlp.w_gate":
                ("shares", 0.001, 0.00026, 0.000665, 5.43e-05),
            "ffn:mlp:dmlp.w_up":
                ("shares", 0.0017, 0.00037, 0.00111, 0.000163),
            "half:attn:dattn.wk": ("shares", 0.12, 0.024, 0.0783, 0.0157),
            "half:attn:dattn.wo":
                ("shares", 0.0086, 0.0014, 0.00567, 0.000922),
            "half:attn:dattn.wq": ("shares", 0.027, 0.004, 0.0175, 0.00266),
            "half:attn:dattn.wv": ("shares", 0.039, 0.0058, 0.0258, 0.00382),
            "half:attn:dln1":
                ("shares", None, 0.071, 0.995, 0.0469, 0.0039, 0.00254),
            "half:attn:dx": ("shares", 0.012, 0.0037, 0.00736, 0.00244),
            "half:mlp:dln2":
                ("shares", None, 0.0079, 0.917, 0.00521, 0.0023, 0.00148),
            "half:mlp:dmlp.w_down":
                ("shares", 0.0028, 0.00082, 0.00182, 0.000543),
            "half:mlp:dmlp.w_gate":
                ("shares", 0.0016, 0.00039, 0.00104, 0.00019),
            "half:mlp:dmlp.w_up":
                ("shares", 0.0018, 0.00041, 0.00115, 0.000203),
            "half:mlp:dx": ("shares", 0.0013, 0.00053, 0.000814, 0.000326),
            "head:dfinal_norm":
                ("shares", None, 0.0002, 0.875, 0.0, 0.00022, 0.000146),
            "head:dtable": ("shares", 0.00027, 0.0002, 6.1e-05, 0.0),
            "head:dx": ("shares", 0.00037, 0.00025, 0.000163, 4.07e-05),
            "layer:attn:dattn.wk": ("shares", 0.71, 0.25, 0.467, 0.162),
            "layer:attn:dattn.wo": ("shares", 0.26, 0.054, 0.169, 0.0355),
            "layer:attn:dattn.wq": ("shares", 0.45, 0.12, 0.299, 0.0763),
            "layer:attn:dattn.wv": ("shares", 0.62, 0.21, 0.411, 0.135),
            "layer:attn:dln1":
                ("shares", None, 0.55, 1.0, 0.365, 0.016, 0.0101),
            "layer:attn:dln2":
                ("shares", None, 0.12, 1.0, 0.0781, 0.0039, 0.00254),
            "layer:attn:dmlp.w_down": ("shares", 0.18, 0.037, 0.117, 0.0241),
            "layer:attn:dmlp.w_gate": ("shares", 0.15, 0.029, 0.097, 0.0191),
            "layer:attn:dmlp.w_up": ("shares", 0.13, 0.025, 0.0837, 0.0165),
            "layer:attn:dx": ("shares", 0.26, 0.098, 0.167, 0.0648),
            "loss:dlogits":
                ("shares", None, 0.0002, 0.903, 0.0, 2.9e-05, 1.91e-05),
            "mixer:attn:dattn.wk": ("shares", 0.086, 0.014, 0.057, 0.0092),
            "mixer:attn:dattn.wo":
                ("shares", 0.0084, 0.0013, 0.00556, 0.000814),
            "mixer:attn:dattn.wq": ("shares", 0.027, 0.0055, 0.018, 0.00361),
            "mixer:attn:dattn.wv": ("shares", 0.048, 0.0052, 0.0317, 0.00342),
            "mixer:attn:dh": ("shares", 0.038, 0.014, 0.0247, 0.00924),
            "model:dblocks.p0.attn.wk":
                ("shares", None, 0.69, 0.772, 0.46, 0.092, 0.0613),
            "model:dblocks.p0.attn.wo":
                ("shares", None, 0.51, 0.675, 0.337, 0.052, 0.0342),
            "model:dblocks.p0.attn.wq":
                ("shares", None, 0.65, 0.756, 0.433, 0.064, 0.0422),
            "model:dblocks.p0.attn.wv":
                ("shares", None, 0.57, 0.712, 0.378, 0.057, 0.0374),
            "model:dblocks.p0.ln1":
                ("shares", None, 0.65, 1.0, 0.43, 0.03, 0.0194),
            "model:dblocks.p0.ln2":
                ("shares", None, 0.12, 1.0, 0.0755, 0.013, 0.00833),
            "model:dblocks.p0.mlp.w_down":
                ("shares", None, 0.49, 0.666, 0.321, 0.07, 0.0465),
            "model:dblocks.p0.mlp.w_gate":
                ("shares", None, 0.56, 0.704, 0.369, 0.061, 0.0401),
            "model:dblocks.p0.mlp.w_up":
                ("shares", None, 0.52, 0.686, 0.346, 0.13, 0.0833),
            "model:dembed.table": ("shares", 0.98, 0.12, 0.649, 0.0768),
            "model:dfinal_norm":
                ("shares", None, 0.0002, 1.0, 0.0, 0.0033, 0.00215),
            "model:loss": ("abs", 0.0023, 0.00153),
        },
        "float32": {
            "model:loss": ("abs", 1e-06, 0.0),
            "*": ("rel", 3.1e-05, 2.01e-05),
        },
    },
    "smollm-360m": {
        "bfloat16": {
            "attn:core:dk": ("shares", 0.0004, 0.0002, 0.000195, 0.0),
            "attn:core:dq": ("shares", 0.0004, 0.0002, 0.000195, 0.0),
            "attn:core:dv": ("shares", 0.0003, 0.0003, 9.77e-05, 9.77e-05),
            "attn:out:dcore": ("shares", 0.00033, 0.0002, 0.00013, 0.0),
            "attn:out:dwo": ("shares", 0.00029, 0.0002, 8.68e-05, 0.0),
            "attn:qkv:dh": ("shares", 0.00088, 0.00046, 0.000586, 0.00026),
            "attn:qkv:dwk": ("shares", 0.0026, 0.00046, 0.00172, 0.00026),
            "attn:qkv:dwq": ("shares", 0.0011, 0.00029, 0.000729, 8.68e-05),
            "attn:qkv:dwv": ("shares", 0.00036, 0.0002, 0.000156, 0.0),
            "embed:dtable": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "ffn:mlp:dh": ("shares", 0.0055, 0.0022, 0.00361, 0.00143),
            "ffn:mlp:dmlp.w_down":
                ("shares", 0.0025, 0.00048, 0.00164, 0.000277),
            "ffn:mlp:dmlp.w_gate":
                ("shares", 0.0038, 0.00088, 0.00253, 0.000586),
            "ffn:mlp:dmlp.w_up": ("shares", 0.0021, 0.00049, 0.0014, 0.000285),
            "half:attn:dattn.wk": ("shares", 0.31, 0.075, 0.206, 0.0496),
            "half:attn:dattn.wo": ("shares", 0.18, 0.032, 0.117, 0.0208),
            "half:attn:dattn.wq": ("shares", 0.24, 0.049, 0.156, 0.0324),
            "half:attn:dattn.wv": ("shares", 0.2, 0.045, 0.128, 0.0296),
            "half:attn:dln1":
                ("shares", None, 0.25, 1.0, 0.163, 0.0082, 0.00545),
            "half:attn:dx": ("shares", 0.073, 0.028, 0.0484, 0.0185),
            "half:mlp:dln2":
                ("shares", None, 0.038, 0.954, 0.025, 0.0015, 0.000965),
            "half:mlp:dmlp.w_down":
                ("shares", 0.0016, 0.00038, 0.00104, 0.000179),
            "half:mlp:dmlp.w_gate":
                ("shares", 0.0013, 0.0003, 0.000846, 9.77e-05),
            "half:mlp:dmlp.w_up":
                ("shares", 0.0032, 0.0011, 0.00211, 0.000732),
            "half:mlp:dx": ("shares", 0.0031, 0.0016, 0.00202, 0.00101),
            "head:dfinal_norm":
                ("shares", None, 0.0063, 0.846, 0.00417, 0.00053, 0.00035),
            "head:dtable": ("shares", 0.0029, 0.00061, 0.00188, 0.000403),
            "head:dx": ("shares", 0.0005, 0.0002, 0.000293, 0.0),
            "layer:attn:dattn.wk": ("shares", 0.94, 0.42, 0.624, 0.275),
            "layer:attn:dattn.wo": ("shares", 0.65, 0.21, 0.427, 0.136),
            "layer:attn:dattn.wq": ("shares", 0.88, 0.37, 0.583, 0.241),
            "layer:attn:dattn.wv": ("shares", 0.9, 0.38, 0.597, 0.25),
            "layer:attn:dln1":
                ("shares", None, 0.64, 1.0, 0.421, 0.021, 0.0135),
            "layer:attn:dln2":
                ("shares", None, 0.38, 1.0, 0.25, 0.011, 0.00684),
            "layer:attn:dmlp.w_down": ("shares", 0.61, 0.2, 0.401, 0.128),
            "layer:attn:dmlp.w_gate": ("shares", 0.58, 0.18, 0.382, 0.118),
            "layer:attn:dmlp.w_up": ("shares", 0.51, 0.16, 0.339, 0.103),
            "layer:attn:dx": ("shares", 0.48, 0.22, 0.32, 0.146),
            "loss:dlogits":
                ("shares", None, 0.0002, 0.927, 0.0, 3.5e-05, 2.29e-05),
            "mixer:attn:dattn.wk": ("shares", 0.16, 0.033, 0.104, 0.0219),
            "mixer:attn:dattn.wo": ("shares", 0.043, 0.0058, 0.0282, 0.00382),
            "mixer:attn:dattn.wq": ("shares", 0.059, 0.012, 0.0388, 0.00757),
            "mixer:attn:dattn.wv": ("shares", 0.059, 0.0091, 0.0389, 0.00604),
            "mixer:attn:dh": ("shares", 0.054, 0.023, 0.0354, 0.0151),
            "model:dblocks.p0.attn.wk":
                ("shares", None, 0.78, 0.806, 0.518, 0.075, 0.0497),
            "model:dblocks.p0.attn.wo":
                ("shares", None, 0.62, 0.738, 0.409, 0.06, 0.0396),
            "model:dblocks.p0.attn.wq":
                ("shares", None, 0.75, 0.794, 0.5, 0.089, 0.0593),
            "model:dblocks.p0.attn.wv":
                ("shares", None, 0.67, 0.76, 0.441, 0.061, 0.0405),
            "model:dblocks.p0.ln1":
                ("shares", None, 0.68, 1.0, 0.45, 0.035, 0.023),
            "model:dblocks.p0.ln2":
                ("shares", None, 0.12, 1.0, 0.0792, 0.013, 0.00831),
            "model:dblocks.p0.mlp.w_down":
                ("shares", None, 0.63, 0.74, 0.414, 0.11, 0.0684),
            "model:dblocks.p0.mlp.w_gate":
                ("shares", None, 0.66, 0.758, 0.438, 0.11, 0.0675),
            "model:dblocks.p0.mlp.w_up":
                ("shares", None, 0.64, 0.75, 0.425, 0.089, 0.059),
            "model:dembed.table":
                ("shares", None, 0.14, 0.715, 0.088, 0.24, 0.154),
            "model:dfinal_norm":
                ("shares", None, 0.0002, 1.0, 0.0, 0.004, 0.00261),
            "model:loss": ("abs", 0.0024, 0.00157),
        },
        "float32": {
            "model:loss": ("abs", 2e-06, 9.54e-07),
            "*": ("rel", 3.8e-05, 2.49e-05),
        },
    },
    "stablelm-1.6b": {
        "bfloat16": {
            "attn:core:dk": ("shares", 0.00048, 0.0002, 0.000275, 0.0),
            "attn:core:dq": ("shares", 0.00042, 0.0002, 0.000214, 0.0),
            "attn:core:dv": ("shares", 0.00051, 0.0002, 0.000305, 0.0),
            "attn:out:dcore": ("shares", 0.00036, 0.0002, 0.000153, 0.0),
            "attn:out:dwo": ("shares", 0.00028, 0.0002, 7.63e-05, 0.0),
            "attn:qkv:dh": ("shares", 0.00027, 0.00024, 6.1e-05, 3.05e-05),
            "attn:qkv:dwk": ("shares", 0.00027, 0.0002, 6.1e-05, 0.0),
            "attn:qkv:dwq": ("shares", 0.00028, 0.0002, 7.63e-05, 0.0),
            "attn:qkv:dwv": ("shares", 0.00028, 0.0002, 7.63e-05, 0.0),
            "embed:dtable": ("shares", 0.0002, 0.0002, 0.0, 0.0),
            "ffn:mlp:dh": ("shares", 0.0011, 0.00048, 0.000732, 0.000275),
            "ffn:mlp:dmlp.w_down":
                ("shares", 0.0015, 0.00046, 0.000946, 0.000259),
            "ffn:mlp:dmlp.w_gate":
                ("shares", 0.00091, 0.00025, 0.000603, 4.58e-05),
            "ffn:mlp:dmlp.w_up":
                ("shares", 0.0012, 0.00035, 0.000763, 0.000145),
            "half:attn:dattn.wk": ("shares", 0.08, 0.015, 0.0531, 0.00978),
            "half:attn:dattn.wo": ("shares", 0.057, 0.011, 0.0378, 0.00717),
            "half:attn:dattn.wq": ("shares", 0.067, 0.014, 0.0444, 0.00919),
            "half:attn:dattn.wv": ("shares", 0.052, 0.0099, 0.0341, 0.00659),
            "half:attn:dln1":
                ("shares", None, 0.12, 1.0, 0.0742, 0.0056, 0.00367),
            "half:attn:dx": ("shares", 0.034, 0.011, 0.0225, 0.00711),
            "half:mlp:dln2":
                ("shares", None, 0.0059, 0.941, 0.00391, 0.0017, 0.00113),
            "half:mlp:dmlp.w_down":
                ("shares", 0.0019, 0.00051, 0.00124, 0.000305),
            "half:mlp:dmlp.w_gate":
                ("shares", 0.0026, 0.00056, 0.00168, 0.000359),
            "half:mlp:dmlp.w_up":
                ("shares", 0.0017, 0.00028, 0.00113, 7.63e-05),
            "half:mlp:dx": ("shares", 0.0022, 0.0012, 0.00143, 0.000763),
            "head:dfinal_norm":
                ("shares", None, 0.0002, 0.859, 0.0, 0.00054, 0.000358),
            "head:dtable": ("shares", 0.00028, 0.0002, 7.63e-05, 0.0),
            "head:dx": ("shares", 0.00033, 0.0002, 0.000122, 0.0),
            "layer:attn:dattn.wk": ("shares", 0.85, 0.34, 0.563, 0.224),
            "layer:attn:dattn.wo": ("shares", 0.56, 0.16, 0.37, 0.106),
            "layer:attn:dattn.wq": ("shares", 0.8, 0.3, 0.528, 0.197),
            "layer:attn:dattn.wv": ("shares", 0.77, 0.29, 0.513, 0.188),
            "layer:attn:dln1": ("shares", None, 0.5, 1.0, 0.328, 0.017, 0.011),
            "layer:attn:dln2":
                ("shares", None, 0.32, 1.0, 0.207, 0.0086, 0.00573),
            "layer:attn:dmlp.w_down": ("shares", 0.52, 0.16, 0.341, 0.103),
            "layer:attn:dmlp.w_gate": ("shares", 0.5, 0.15, 0.332, 0.0946),
            "layer:attn:dmlp.w_up": ("shares", 0.42, 0.12, 0.278, 0.0734),
            "layer:attn:dx": ("shares", 0.46, 0.2, 0.306, 0.131),
            "loss:dlogits":
                ("shares", None, 0.0002, 0.93, 0.0, 3.2e-05, 2.1e-05),
            "mixer:attn:dattn.wk": ("shares", 0.064, 0.011, 0.0426, 0.00732),
            "mixer:attn:dattn.wo": ("shares", 0.056, 0.011, 0.0372, 0.00677),
            "mixer:attn:dattn.wq": ("shares", 0.059, 0.011, 0.039, 0.00671),
            "mixer:attn:dattn.wv": ("shares", 0.036, 0.0048, 0.0239, 0.00317),
            "mixer:attn:dh": ("shares", 0.063, 0.024, 0.0417, 0.0156),
            "model:dblocks.p0.attn.wk":
                ("shares", None, 0.72, 0.782, 0.477, 0.089, 0.0591),
            "model:dblocks.p0.attn.wo":
                ("shares", None, 0.57, 0.71, 0.376, 0.056, 0.0372),
            "model:dblocks.p0.attn.wq":
                ("shares", None, 0.72, 0.783, 0.479, 0.09, 0.0596),
            "model:dblocks.p0.attn.wv":
                ("shares", None, 0.59, 0.723, 0.389, 0.11, 0.0708),
            "model:dblocks.p0.ln1":
                ("shares", None, 0.59, 1.0, 0.391, 0.026, 0.017),
            "model:dblocks.p0.ln2":
                ("shares", None, 0.094, 1.0, 0.0625, 0.012, 0.00748),
            "model:dblocks.p0.mlp.w_down":
                ("shares", None, 0.59, 0.725, 0.39, 0.08, 0.0527),
            "model:dblocks.p0.mlp.w_gate":
                ("shares", None, 0.64, 0.746, 0.422, 0.099, 0.0659),
            "model:dblocks.p0.mlp.w_up":
                ("shares", None, 0.62, 0.738, 0.41, 0.07, 0.0463),
            "model:dembed.table": ("shares", 0.96, 0.11, 0.636, 0.073),
            "model:dfinal_norm":
                ("shares", None, 0.0002, 1.0, 0.0, 0.0035, 0.00233),
            "model:loss": ("abs", 0.0022, 0.00141),
        },
        "float32": {
            "model:loss": ("abs", 2e-06, 9.54e-07),
            "*": ("rel", 2.9e-05, 1.92e-05),
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


# (reduced shape, summed dims, how the reference's transpose reaches it)
SUM_CASES = [((64, 32), (1,), "row"), ((64, 256), (1,), "row"),
             ((8, 7168), (1,), "row"), ((2, 96, 256), (0, 1), "bias"),
             ((4, 512, 64), (0, 1), "bias"), ((2, 3, 4, 8, 16), (2,), "rep")]


@pytest.mark.parametrize("shape, dims, how", SUM_CASES)
def test_rounded_sum_is_the_references_reduction(shape, dims, how):
    """``ops.rounded_sum`` on bf16 gives, bit for bit, what the reference's
    compiled transposes give: a row-scale's pullback (the MoE gates'
    gradient, sums over D up to kimi-k2's 7,168), a bias's (the convs'
    weights and biases, over (B, S)) and a repeat's (flash's GQA keys and
    values, over the group); on f32 it is ``torch.sum``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro_torch.kernels import ops as T_K
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    kept = tuple(n for i, n in enumerate(shape) if i not in dims)
    if how == "row":
        def f(c):
            return jax.vjp(lambda w: jnp.ones(shape, jnp.bfloat16)
                           * w[:, None], jnp.zeros(kept, jnp.bfloat16))[1](c)
    elif how == "bias":
        def f(c):
            return jax.vjp(lambda b: jnp.zeros(shape, jnp.bfloat16)
                           + b[None, None],
                           jnp.zeros(kept, jnp.bfloat16))[1](c)
    else:
        def f(c):
            k = jnp.zeros(shape[:2] + shape[3:], jnp.bfloat16)
            return jax.vjp(lambda a: jnp.repeat(a[:, :, None], shape[2],
                                                axis=2), k)[1](c)
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(jax.jit(f)(x)[0].astype(jnp.float32))
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()
    got = T_K.rounded_sum(tx, dims).float().numpy()
    assert np.array_equal(got, want.reshape(got.shape)), (
        f"{np.mean(got != want.reshape(got.shape)):.4%} differ")
    xf = tx.float()
    assert torch.equal(T_K.rounded_sum(xf, dims), xf.sum(dims))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "silu_f32", "gelu"])
def test_activation_backward_is_finite_and_the_references(act, dtype):
    """The activations' pullback at |x| >= 90, where ``exp(-x)`` (or x^3)
    overflows: finite, and equal to the gradient of ``jax.nn.silu`` /
    ``gelu`` compiled under ``jax.jit`` (``silu_f32``: silu read in f32):
    bit for bit in bf16, there and between -10 and 10; in f32 within atol
    and rtol 1e-5, the f32 tolerance (XLA's f32 ``exp`` and ``tanh`` are
    not PyTorch's: its tanh stops short of 1 far out, so gelu's gradient
    there keeps a term of 1e-6; measured at most 4.7e-6 apart)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro_torch.models import layers as T_L
    rng = np.random.default_rng(1)
    big = np.concatenate([np.linspace(90, 3e4, 500),
                          -np.linspace(90, 3e4, 500)])
    jdt = jnp.dtype(dtype)
    fn = {"silu": jax.nn.silu, "gelu": jax.nn.gelu,
          "silu_f32": lambda v: jax.nn.silu(v).astype(jnp.float32)}[act]
    exact = dtype == "bfloat16"
    for xs in (big, rng.normal(size=4096) * 3):
        x = jnp.asarray(xs, jdt)
        out = jax.eval_shape(fn, x)
        g = jnp.asarray(rng.normal(size=xs.shape), out.dtype)
        with jax.default_device(jax.devices("cpu")[0]):
            want = np.asarray(jax.jit(lambda a, c: jax.vjp(fn, a)[1](c)[0])(
                x, g).astype(jnp.float32))
        tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
            getattr(torch, dtype)).requires_grad_()
        tg = torch.from_numpy(np.asarray(g.astype(jnp.float32))).to(
            torch.float32 if act == "silu_f32" else getattr(torch, dtype))
        (got,) = torch.autograd.grad(getattr(T_L, act)(tx), tx, tg)
        got = got.float().numpy()
        assert np.isfinite(got).all()
        if exact:
            assert np.array_equal(got, want), np.abs(got - want).max()
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

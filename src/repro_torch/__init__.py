"""PyTorch/CUDA port of the DySTop simulation plane.

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro_torch.core.planner`` <-> ``repro.core.planner``, ...) and
imports neither ``jax`` nor anything of ``repro``.  Every entry point runs on
the CUDA card unless the caller asks for ``device="cpu"``; the two kernels of
the main path (``kernels.aggregate``, ``kernels.fused_sgd``) are hand-written
CUDA C++ for ``sm_90a``, built from ``kernels/csrc`` at first use, and fall to
their plain PyTorch versions only for tensors that lie on the CPU.
"""

"""The port's kernels: hand-written CUDA for sm_90a, each beside its plain
PyTorch version (``aggregate``, ``fused_sgd``, ``flash_attention``,
``ssd_chunk``)."""

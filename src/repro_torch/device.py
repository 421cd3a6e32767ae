"""Where the port's entry points run: the card unless the caller asks for
the CPU, whose tensors run the kernels' plain versions (or, where an entry
point takes it, the ``meta`` device: shapes and dtypes, no data)."""
from __future__ import annotations

import torch


def resolve_device(device, what: str, meta: bool = False) -> torch.device:
    """``device`` ("cuda" or "cpu", or "meta" where ``meta`` allows it; a
    string or a ``torch.device``) as a torch device; "cuda" without a card
    raises, naming ``device='cpu'``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: device {str(device)!r} asked for, but PyTorch sees no "
            f"CUDA card; pass device='cpu' to run the plain versions on the "
            f"CPU")
    allowed = ("cpu", "cuda", "meta") if meta else ("cpu", "cuda")
    if dev.type not in allowed:
        raise ValueError(f"{what}: device must be one of {allowed}, got "
                         f"{str(device)!r}")
    return dev

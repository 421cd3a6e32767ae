"""Where the port's entry points run: the card unless the caller asks for
the CPU, whose tensors run the kernels' plain versions."""
from __future__ import annotations

import torch


def resolve_device(device, what: str) -> torch.device:
    """``device`` ("cuda" or "cpu", a string or a ``torch.device``) as a
    torch device; "cuda" without a card raises, naming ``device='cpu'``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: device {str(device)!r} asked for, but PyTorch sees no "
            f"CUDA card; pass device='cpu' to run the plain versions on the "
            f"CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: device must be 'cuda' or 'cpu', got "
                         f"{str(device)!r}")
    return dev

"""Device choice for the torch port: explicit, and never a silent fallback."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device a converter runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (or left as the default) and no card is
    present; the CPU runs only when the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return dev

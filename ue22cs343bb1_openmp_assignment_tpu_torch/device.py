"""Device resolution for the port's entry points.

``None`` means the card. Nothing falls back to the CPU by itself: a
caller that wants the CPU (the parity tests) says ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The torch.device an entry point builds its state on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev

"""Device resolution: ``None`` means the CUDA card, and there is no fallback.

A caller that wants the CPU (the tests, a host-only tool) says so with
``device="cpu"``; everything else runs on the card or raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; a string or device passes
    through. Raises ``RuntimeError`` for a CUDA device when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

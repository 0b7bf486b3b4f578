"""Device selection for the port's entry points.

An entry point runs on the card unless its caller asks for the CPU:
``resolve_device()`` raises when CUDA is asked for and absent, and nothing
picks the CPU by itself.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it is a
    CUDA device and no CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch finds no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return dev

"""PyTorch/CUDA port of ``repro``: the serving slice.

It mirrors ``repro``'s module layout and imports neither ``jax`` nor
``repro``. Prefill and decode attention run in hand-written CUDA kernels
(``repro_torch/csrc``); entry points run on the card unless the caller
passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

"""Optimizers: the paper's shared-statistics RMSProp, Adam, SGD.

The paper (§5.1) trains with RMSProp (decay 0.99, ε=0.1) and global-norm
gradient clipping at 40. "Shared statistics" means a single copy of the
second-moment accumulator updated synchronously — which is exactly what a
single optimizer state is here.

As in ``repro.optim``, ``update(grads, state, params, lr)`` is functional:
it returns new parameter and state trees of new tensors, laid out as the
reference's (``{"sq": tree}``, ``{"m", "v", "t"}``, ``{"mom": tree}``), and
leaves its arguments as they were. It runs under ``torch.no_grad()``;
moments are kept in float32. The clip scale stays on the device, so an
update never waits for the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.utils.tree import tree_global_norm, tree_leaves, tree_map


def clip_by_global_norm(grads, max_norm: float):
    """Paper §5.1: scale every gradient by ``min(1, max_norm / norm)``.
    Returns ``(clipped grads, norm)``."""
    norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (new_params, new_state)


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def make_optimizer(
    kind: str = "rmsprop",
    *,
    decay: float = 0.99,
    eps: float = 0.1,
    beta1: float = 0.9,
    beta2: float = 0.999,
    momentum: float = 0.0,
    clip_norm: Optional[float] = 40.0,
) -> Optimizer:
    """Build an optimizer. Defaults follow the paper's hyperparameters."""

    def maybe_clip(grads):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        return grads

    if kind == "rmsprop":

        def init(params):
            return {"sq": tree_map(_zeros, params)}

        @torch.no_grad()
        def update(grads, state, params, lr):
            grads = maybe_clip(grads)
            sq = tree_map(lambda s, g: decay * s + (1.0 - decay) * g.float().square(),
                          state["sq"], grads)
            new_params = tree_map(
                lambda p, g, s: (p.float() - lr * g.float() / (s.sqrt() + eps)
                                 ).to(p.dtype),
                params, grads, sq)
            return new_params, {"sq": sq}

        return Optimizer(init, update)

    if kind == "adam":

        def init(params):
            device = tree_leaves(params)[0].device
            return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params),
                    "t": torch.zeros((), dtype=torch.int32, device=device)}

        @torch.no_grad()
        def update(grads, state, params, lr):
            grads = maybe_clip(grads)
            t = state["t"] + 1
            m = tree_map(lambda m_, g: beta1 * m_ + (1 - beta1) * g.float(),
                         state["m"], grads)
            v = tree_map(lambda v_, g: beta2 * v_ + (1 - beta2) * g.float().square(),
                         state["v"], grads)
            tf = t.float()
            bc1 = 1 - torch.pow(beta1, tf)
            bc2 = 1 - torch.pow(beta2, tf)
            new_params = tree_map(
                lambda p, m_, v_: (p.float() - lr * (m_ / bc1)
                                   / ((v_ / bc2).sqrt() + 1e-8)).to(p.dtype),
                params, m, v)
            return new_params, {"m": m, "v": v, "t": t}

        return Optimizer(init, update)

    if kind == "sgd":

        def init(params):
            return {"mom": tree_map(_zeros, params)} if momentum else {}

        @torch.no_grad()
        def update(grads, state, params, lr):
            grads = maybe_clip(grads)
            if momentum:
                mom = tree_map(lambda m_, g: momentum * m_ + g.float(),
                               state["mom"], grads)
                new_params = tree_map(
                    lambda p, m_: (p.float() - lr * m_).to(p.dtype), params, mom)
                return new_params, {"mom": mom}
            new_params = tree_map(
                lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                params, grads)
            return new_params, state

        return Optimizer(init, update)

    raise ValueError(f"unknown optimizer {kind}")

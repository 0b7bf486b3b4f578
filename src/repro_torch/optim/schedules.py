"""Learning-rate schedules: ``step`` (an int) -> learning rate (a float).

``paac_scaled_lr`` implements the paper's §5.2 batch-size rule: the base
learning rate is scaled linearly with the number of actors,
``α = 0.0007 · n_e``.
"""
from __future__ import annotations


def constant(lr: float):
    return lambda step: float(lr)


def linear_anneal(lr: float, total_steps: int, floor: float = 0.0):
    """A3C-style anneal to ``floor`` over ``total_steps``."""

    def fn(step):
        frac = min(max(1.0 - step / total_steps, 0.0), 1.0)
        return floor + (lr - floor) * frac

    return fn


def paac_scaled_lr(n_e: int, base: float = 0.0007):
    """Paper §5.2: learning rate scaled with actor count."""
    return constant(base * n_e)

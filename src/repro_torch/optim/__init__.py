from repro_torch.optim.optimizer import (Optimizer, clip_by_global_norm,
                                         make_optimizer)
from repro_torch.optim.schedules import constant, linear_anneal, paac_scaled_lr

__all__ = [
    "Optimizer",
    "make_optimizer",
    "clip_by_global_norm",
    "constant",
    "linear_anneal",
    "paac_scaled_lr",
]

"""The numbers that decide ``correct``: a training run's first steps held
against the plain reference's, which follows the program's weights from
update to update (``paac_reference``).

- ``init_gap``: the largest difference of an initial weight (exact: both
  sides draw them from the seed).
- ``act_gap``: the widest gap by which a sampled action's perturbed logit
  lies below the best one, under the reference's logits.
- ``loss_gap``: the first step's loss, its gap over the sum of the
  magnitudes of its three terms in the reference.
- ``grad_gap``: the median leaf's gap between the norm of the first
  gradient as the optimizer got it (worked out from RMSProp's accumulator
  after one step) and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf.
- ``head_grad_gap``: the same gap's worst over the heads' leaves, which
  lie after the last ReLU.
- ``change_gap``: the same for the norm of each leaf's change in each
  step, from the program's weights before it; the worst step's median
  leaf. Leaves whose reference gradient is under a thousandth of the
  median leaf's move by round-off alone and are left out.
- ``staleness_max`` (a pipelined run's): the most updates by which a
  rollout of the checked call was acted behind the learner; the ring's
  depth bounds it (``queue_depth + 1`` for one actor).

A ReLU whose input lies within float32's rounding of 0 takes the other
side than in float64 on a few seeds; its unit's gradient then differs
whole. That moves the leaves before it (the worst leaf's gap reads 1e-5
to 2e-4, and the median leaf's up to some 5e-5 with a flip in a
convolution) and leaves the first loss and the heads' first gradient
steady. Once the value head has learned (the third step), float32's
rounding of the value error grows by its cancellation: the value head
and the trunk then read 1e-6 to 4e-6 in the change, the policy head not.
``extra`` gives the numbers not compared: the worst leaf's gaps, each
step's loss gap and median-leaf change gap, the heads' worst change gap
(``head_change_gap``), the gap of the mean importance weight, each leaf's
first-gradient and change gaps, and the behaviour versions.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

STILL = 1e-3  # a leaf's gradient norm under this share of the median's
HEADS = "heads/"  # the leaves after the last ReLU


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _gaps(prog: Dict[str, float], ref: Dict[str, float],
          keep) -> Dict[str, float]:
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def numbers(prog, ref, decay: float, extra: bool = False) -> Dict[str, float]:
    """``prog`` and ``ref`` are ``reference.Observed``; ``ref`` followed
    ``prog``'s actions and weights. Missing or extra leaves or steps raise
    ``KeyError``."""
    if len(prog.after) != len(ref.after) or len(prog.losses) != len(ref.losses):
        raise KeyError(f"steps differ: program {len(prog.after)}, reference "
                       f"{len(ref.after)}")
    if set(prog.init) != set(ref.init):
        raise KeyError(f"parameter leaves differ: program {sorted(prog.init)}"
                       f", reference {sorted(ref.init)}")
    init_gap = max(float((prog.init[k].double().cpu()
                          - ref.init[k].double().cpu()).abs().max())
                   for k in ref.init)
    loss_gaps = [
        abs(p["loss"] - r["loss"]) / (abs(r["policy_loss"]) + abs(r["entropy"])
                                      + abs(r["value_loss"]))
        for p, r in zip(prog.losses, ref.losses)]
    grad_ref = _norms(ref.grad1)
    grad_prog = {k: math.sqrt(float(v.double().sum()) / (1.0 - decay))
                 for k, v in prog.sq1.items()}
    med = statistics.median(grad_ref.values())
    moving = [k for k, v in grad_ref.items() if v >= STILL * med]
    grad = _gaps(grad_prog, grad_ref, list(grad_ref))
    changes = []  # each step's gaps, from the program's weights before it
    for i, (p_after, r_after) in enumerate(zip(prog.after, ref.after)):
        before = prog.init if i == 0 else prog.after[i - 1]
        base = {k: before[k].double().cpu() for k in moving}
        changes.append(_gaps(
            _norms({k: p_after[k].double().cpu() - base[k] for k in moving}),
            _norms({k: r_after[k].double().cpu() - base[k] for k in moving}),
            moving))
    change_med = [statistics.median(c.values()) for c in changes]
    out = {"init_gap": init_gap, "act_gap": ref.act_gap,
           "loss_gap": loss_gaps[0],
           "grad_gap": statistics.median(grad.values()),
           "head_grad_gap": max(v for k, v in grad.items()
                                if k.startswith(HEADS)),
           "change_gap": max(change_med)}
    if prog.staleness_max is not None:
        out["staleness_max"] = prog.staleness_max
    if extra:
        rho = [abs(p["rho_mean"] - r["rho_mean"])
               for p, r in zip(prog.losses, ref.losses) if "rho_mean" in p]
        out.update(rho_gap=max(rho, default=0.0), loss_gaps=loss_gaps,
                   change_gaps=change_med, versions=list(prog.versions),
                   head_change_gap=max(v for c in changes
                                       for k, v in c.items()
                                       if k.startswith(HEADS)),
                   grad_gap_worst=max(grad.values()),
                   change_gap_worst=max(max(c.values()) for c in changes),
                   grad_gap_by_leaf=grad, change_gaps_by_leaf=changes)
    return out

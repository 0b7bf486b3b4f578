"""Roofline terms and model FLOPs (a port of ``repro.launch.analysis``),
on the H100's constants (``launch/mesh.py``).

Three terms per (arch, shape, mesh), in seconds:

    compute    = FLOPs_per_device / peak bf16 FLOP/s
    memory     = bytes_per_device / HBM bytes/s
    collective = wire_bytes_per_device / NVLink bytes/s (each way)

The per-device counts come from ``trace_analysis.LocalCostMode`` in the
dry-run. Past 8 cards a 16-wide axis leaves the NVLink domain, so the
collective term is a lower bound there. ``model_flops`` is the useful-work
yardstick, 6 · N_active · tokens (a forward and a backward; a forward
alone is a third of it). ``mfu_params`` is the N of an MFU's numerator:
the same count without the token embedding, a gather that does no FLOPs.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.utils.tree import tree_paths

__all__ = ["active_params", "mfu_params", "model_flops", "roofline_terms"]


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   wire_bytes_per_chip: float) -> Dict[str, float]:
    compute = flops_per_chip / PEAK_FLOPS_BF16
    memory = bytes_per_chip / HBM_BW
    collective = wire_bytes_per_chip / NVLINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    return terms


def active_params(cfg, params_tree) -> float:
    """Parameter count weighted by MoE activation (top-k of E experts); the
    leaves may be tensors, meta or fake tensors (only shapes are read)."""
    total = 0.0
    for path, leaf in tree_paths(params_tree):
        parts = [str(k) for k in path]
        pstr = "/".join(parts)
        size = 1
        for d in leaf.shape:
            size *= d
        if (cfg.num_experts and "/moe/" in pstr and parts[-2] == "moe") or (
                cfg.num_experts and "moe" in pstr
                and parts[-1] in ("wi", "wg", "wo")):
            size = size * cfg.num_experts_per_tok / cfg.num_experts
        total += size
    return total


def model_flops(cfg, params_tree, tokens: int) -> float:
    """MODEL_FLOPS = 6 · N_active · D."""
    return 6.0 * active_params(cfg, params_tree) * tokens


def mfu_params(cfg, params_tree) -> float:
    """``active_params`` less the token embedding table, which a step reads
    by gather (no FLOPs) unless the policy head multiplies by it."""
    n = active_params(cfg, params_tree)
    if cfg.tie_policy_head:
        return n
    return n - sum(leaf.numel() for path, leaf in tree_paths(params_tree)
                   if str(path[-1]) == "embed")

"""Mixture-of-Experts block (DeepSeek-V2 / DBRX style), the port's
counterpart of ``repro/models/moe.py``.

The reference's design, kept here:

* **Sort dispatch into a fixed capacity buffer.** Each token picks its
  top-k experts; the assignments are sorted by expert (stably, so earlier
  tokens win), each gets a rank within its expert, and those with rank <
  capacity fill a fixed (E, C, d) buffer, the rest drop (GShard's capacity
  drop). Every shape is static: no host sync, nothing data-dependent in a
  shape.
* **Group-local routing.** Tokens are routed in groups of
  ``moe_group_size`` along the sequence; a row shorter than that is one
  group, and a single-token decode step routes the whole batch as one
  group.
* The router runs in fp32; shared experts (DeepSeek-V2) are one dense
  SwiGLU MLP applied to every token; the Switch aux loss is returned.
* Every expert runs its whole capacity buffer, tokens or not, as the
  reference's einsums do: a decode step reads every expert's weights. The
  expert products are batched matmuls over the expert axis on the stacked
  (E, in, out) weights, which are never copied.

Torch-specific choices:

* **Top-k ties go to the lower expert id**, as ``lax.top_k`` orders them
  (``torch.topk`` promises no order): a stable descending sort.
* **No out-of-range writes.** The reference scatters overflow assignments
  to index E·C with ``mode="drop"``; here the scatter targets have one
  extra sink entry that is sliced off, and the dispatch gathers from a zero
  row T appended to the tokens.
* **The combine is a gather**, y[t] = Σ_j out[slot[t, j]] · w[t, j] summed
  over j in order with a zero sink row, which equals the reference's
  scatter-add (``tests/test_extensions.py``'s combine test). A scatter-add
  with repeated indices would use atomics on the card and not repeat
  bitwise; the gather does, which the serving plane's solo pin needs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.models.mlp import init_mlp, mlp_forward


def init_moe(generator, cfg, dtype):
    """Router (d, E) in fp32; expert weights ``wi``/``wg`` (E, d, ff) and
    ``wo`` (E, ff, d) drawn as randn / sqrt(in); shared experts as one
    SwiGLU MLP of width ff · num_shared_experts. Each expert's slice is drawn
    on its own, so the fp32 transient of a draw is one expert's, not the
    whole stack's."""
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.expert_ff()
    device = generator.device

    def experts(n_in, n_out):
        w = torch.empty((E, n_in, n_out), dtype=dtype, device=device)
        for e in range(E):
            draw = torch.randn((n_in, n_out), generator=generator,
                               device=device)
            w[e] = draw.div_(math.sqrt(n_in))
        return w

    p = {"router": {"w": dense_init(generator, d, E, torch.float32)},
         "wi": experts(d, ff), "wg": experts(d, ff), "wo": experts(ff, d)}
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(generator, d, ff * cfg.num_shared_experts,
                               dtype, "swiglu")
    return p


def _top_k(probs, k: int):
    """``lax.top_k`` along the last axis: the k largest, ties to the lower
    index."""
    idx = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    return probs.gather(-1, idx), idx


# hot-path
def _route_group(tokens, router_logits, k: int, capacity: int, E: int):
    """Route groups of tokens: tokens (..., T, d), logits (..., T, E) fp32;
    any leading axes are independent groups (the reference vmaps over them).

    Returns (expert_in (..., E, C, d), slot (..., T, k), weights (..., T, k),
    aux_loss (...), inv_tok (..., E*C), w_slot (..., E*C)): which slot each
    assignment took (E*C where it dropped), which token each slot holds (T
    where it is empty) and the slot's combine weight.
    """
    *lead, T, d = tokens.shape
    dev = tokens.device
    C = capacity
    probs = torch.softmax(router_logits, dim=-1)  # (..., T, E)
    top_w, top_e = _top_k(probs, k)  # (..., T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    experts = torch.arange(E, device=dev)
    assign_frac = (top_e[..., None] == experts).float().sum(-2).mean(-2)
    aux = E * (assign_frac * probs.mean(-2)).sum(-1)

    # flatten assignments and sort them by expert id
    flat_e = top_e.reshape(*lead, T * k)
    flat_tok = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(-1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(-1, order)
    sorted_tok = flat_tok[order]
    sorted_w = top_w.reshape(*lead, T * k).gather(-1, order)
    # rank of each assignment within its expert
    start = torch.searchsorted(sorted_e,
                               experts.expand(*lead, E).contiguous())
    rank = torch.arange(T * k, device=dev) - start.gather(-1, sorted_e)
    slot_sorted = torch.where(rank < C, sorted_e * C + rank, E * C)
    # slot-major metadata; dropped assignments land on the sink entry E*C
    inv_tok = torch.full((*lead, E * C + 1), T, dtype=torch.long, device=dev)
    inv_tok = inv_tok.scatter(-1, slot_sorted, sorted_tok)[..., :E * C]
    w_slot = torch.zeros((*lead, E * C + 1), dtype=torch.float32, device=dev)
    w_slot = w_slot.scatter(-1, slot_sorted, sorted_w)[..., :E * C]
    # dispatch as one slot-indexed gather; empty slots read the zero row T
    tokens_pad = torch.cat([tokens, tokens.new_zeros((*lead, 1, d))], dim=-2)
    buf = tokens_pad.gather(-2, inv_tok[..., None].expand(*lead, E * C, d))
    # map back: the slot of (token, j) in the original order
    slot = torch.empty_like(slot_sorted).scatter(-1, order, slot_sorted)
    return (buf.reshape(*lead, E, C, d), slot.reshape(*lead, T, k), top_w,
            aux, inv_tok, w_slot)


# hot-path
def moe_forward(p, cfg, x):
    """x (B, S, d) -> (output (B, S, d), aux_loss scalar)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    group_size = cfg.moe_group_size

    # grouping: sequence chunks for long rows, the batch for single-token
    # decode, otherwise each row
    if S >= group_size:
        if S % group_size:
            raise ValueError(f"seq {S} not divisible by group {group_size}")
        xg = x.reshape(B * (S // group_size), group_size, d)
    else:
        xg = x.reshape(1, B * S, d) if S == 1 else x
    G, T, _ = xg.shape
    # the reference's float expression; math.ceil of a float is an int
    capacity = max(math.ceil(T * k * cfg.moe_capacity_factor / E), 1)

    logits = xg.float() @ p["router"]["w"].float()  # (G, T, E)
    expert_in, slot, top_w, aux, _, _ = _route_group(xg, logits, k,
                                                     capacity, E)
    # the experts: one batched product over E, each on its G*C rows
    h_in = expert_in.transpose(0, 1).reshape(E, G * capacity, d)
    h = F.silu(h_in @ p["wi"]) * (h_in @ p["wg"])
    out = (h @ p["wo"]).reshape(E, G, capacity, d).transpose(0, 1)

    # combine: gather each assignment's slot output (the sink row E*C is
    # zero) and sum the weighted outputs over j in order
    flat = torch.cat([out.reshape(G, E * capacity, d),
                      out.new_zeros((G, 1, d))], dim=1)
    picked = flat.gather(1, slot.reshape(G, T * k, 1).expand(G, T * k, d))
    picked = picked.reshape(G, T, k, d)
    w = top_w.to(out.dtype)
    y = picked[:, :, 0] * w[..., 0, None]
    for j in range(1, k):
        y = y + picked[:, :, j] * w[..., j, None]
    y = y.reshape(B, S, d)

    if "shared" in p:
        y = y + mlp_forward(p["shared"], x)
    return y, aux.mean()

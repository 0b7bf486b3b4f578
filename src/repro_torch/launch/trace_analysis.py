"""Per-device costs of one step from a trace of its local ops (the port's
counterpart of ``repro.launch.hlo_analysis``, which reads them from the
optimized HLO text).

The dry-run runs a step as DTensor ops on a fake process group. DTensor
turns each global op into the op on one device's local shards, plus the
collectives its placements need. ``LocalCostMode`` is a dispatch mode
that sees only that local half: given a DTensor it returns
``NotImplemented``, so DTensor's dispatch runs and its local ops come back
through the mode on plain (fake) tensors. So every count is one device's:

* **FLOPs**: ``torch.utils.flop_counter``'s formula for each local op
  (matrix products, convolutions, attention). ``FlopCounterMode`` above
  DTensor would count the whole mesh's work, the global op's;
* **bytes**: each local op's distinct tensor operands plus its result.
  Eager mode has no fusion, so one op is one round trip to memory: the
  counterpart of the reference's count of one fusion as one unit. Views,
  metadata ops and ops on the meta device move nothing and are not
  counted; nor are the ops DTensor runs on global shapes to propagate a
  result's shape and stride;
* **collectives**: each functional collective's count and its wire bytes,
  the result's bytes times the ring factor of the reference's model
  (all-reduce 2(N-1)/N, all-gather, reduce-scatter and all-to-all (N-1)/N
  of the result, anything else 1.0), with N the group's size. The mode
  runs a step once; a layer loop in Python is unrolled, so there are no
  trip counts to multiply.

``by_op`` keeps each contributor's total (``scripts/diag_pair_torch.py``
ranks them).
"""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["LocalCostMode", "wire_factor"]

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
# ops that move no data: shape/device queries and uninitialised factories
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "device", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size", "detach"}

_state = threading.local()


def wire_factor(op: str, n: int) -> float:
    """Wire bytes a result byte costs each device in a ring of ``n``."""
    if n <= 1:
        return 0.0
    if op == "all_reduce":
        return 2.0 * (n - 1) / n
    if op in ("all_gather", "reduce_scatter", "all_to_all"):
        return (n - 1) / n
    return 1.0


def _tensors(tree):
    out = []
    for x in torch.utils._pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    schema = func._schema
    names = [a.name for a in schema.arguments]
    vals = dict(zip(names, args))
    vals.update(kwargs)
    if "group_size" in vals:
        return int(vals["group_size"])
    return _resolve_process_group(vals["group_name"]).size()


@contextlib.contextmanager
def _shape_propagation_unseen():
    """Mark DTensor's shape propagation (the op on global fake tensors, to
    learn its result's shape) so that the mode does not count it."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, op_schema):
        prev = getattr(_state, "propagating", False)
        _state.propagating = True
        try:
            return orig(self, op_schema)
        finally:
            _state.propagating = prev

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


class LocalCostMode(TorchDispatchMode):
    """Counts one device's FLOPs, bytes and collectives (see the module's
    docstring). Read ``report()`` after the context."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.wire = defaultdict(float)
        self.counts = defaultdict(int)
        # (kind, op, result shape) -> bytes or wire bytes, for diagnosis
        self.by_op: Dict[tuple, float] = defaultdict(float)
        self._ctx = None

    def __enter__(self):
        self._ctx = _shape_propagation_unseen()
        self._ctx.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._ctx.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not getattr(_state, "propagating", False):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        results = _tensors(out)
        shape = tuple(results[0].shape) if results else ()
        if ns == "_c10d_functional":
            base = next((c for c in COLLECTIVES if name.startswith(c)), None)
            if base is None:  # wait_tensor and the like
                return
            n = _group_size(func, args, kwargs)
            wire = sum(_nbytes(t) for t in results) * wire_factor(base, n)
            self.wire[base] += wire
            self.counts[base] += 1
            self.by_op[("wire", f"{name}/{n}", shape)] += wire
            return
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view or name in _FREE or ns == "prim" or (
                results and all(t.device.type == "meta" for t in results)):
            return
        seen, nb = set(), 0
        for t in _tensors((args, kwargs)) + results:
            if id(t) not in seen:
                seen.add(id(t))
                nb += _nbytes(t)
        self.bytes += nb
        self.by_op[("bytes", f"{ns}.{name}", shape)] += nb

    def report(self) -> Dict[str, float]:
        """The keys of the reference's ``analyze_hlo``: ``flops``,
        ``bytes``, ``collective_wire_bytes``, ``wire_<op>`` and
        ``collective_counts``."""
        out = {"flops": float(self.flops), "bytes": float(self.bytes),
               "collective_wire_bytes": float(sum(self.wire.values()))}
        for k, v in self.wire.items():
            out[f"wire_{k}"] = v
        out["collective_counts"] = dict(self.counts)
        return out

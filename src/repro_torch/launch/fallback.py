"""Replicated fallbacks for ops that DTensor cannot shard (the dry-run's).

The reference's dry-run hands the whole step to XLA's partitioner, which
shards or gathers every op. DTensor refuses an op it has no sharding rule
for (``aten.searchsorted`` in the MoE dispatch, say), and an op whose rule
cannot split its inputs' placements (a view that regroups a dim unevenly
split over a mesh axis: 40 heads on a 16-way axis). ``replicate_fallbacks``
catches both: while it is active, such an op gets a strategy that
replicates every input and output on every mesh dim, so DTensor
all-gathers the inputs first. Each fallback is recorded with the bytes
the gathers bring to each device (the global size of every sharded input),
and the dry-run lists them in its report. Nothing is skipped in silence:
an op that fails even replicated raises.

The context also lets DTensor work out shard offsets under the fake
mode: a ``_StridedShard`` (a dim split over two mesh axes by a view that
merged two sharded dims) and an arg-max over a sharded dim read their
offsets from an index tensor (``.tolist()``, ``int()``), which has no
values there; those computations run outside it, on real index tensors
of a dim's length.
"""
from __future__ import annotations

import contextlib
import functools
import math
from collections import defaultdict
from typing import Dict

import torch

__all__ = ["replicate_fallbacks"]


def _is_spec(x) -> bool:
    from torch.distributed.tensor._dtensor_spec import DTensorSpec

    return isinstance(x, DTensorSpec)


def _gathered_bytes(op_schema) -> int:
    """Global bytes of the inputs split over a mesh dim of more than one
    device (what replicating them gathers)."""
    total = 0
    leaves = torch.utils._pytree.tree_leaves((op_schema.args_schema,
                                              op_schema.kwargs_schema))
    for spec in leaves:
        if not (_is_spec(spec) and spec.tensor_meta):
            continue
        if any(not p.is_replicate() and spec.mesh.size(i) > 1
               for i, p in enumerate(spec.placements)):
            meta = spec.tensor_meta
            total += math.prod(meta.shape) * meta.dtype.itemsize
    return total


def _replicate_all(n_out: int):
    from torch.distributed.tensor import Replicate

    def strategy(*args, **kwargs):
        n_in = sum(_is_spec(x) for x in
                   torch.utils._pytree.tree_leaves((args, kwargs)))
        return [([Replicate()] * n_out, [Replicate()] * n_in)]

    return strategy


def _replicated(prop, op_schema, orig):
    """``orig(op_schema)`` with ``op_schema.op``'s strategy replaced by
    ``_replicate_all`` for the call."""
    from torch.distributed.tensor.experimental import register_sharding

    op = op_schema.op
    saved = {name: getattr(prop, name).pop(op, None)
             for name in ("op_strategy_funcs", "op_to_schema_info",
                          "op_single_dim_strategy_funcs", "op_to_rules")}
    try:
        register_sharding(op)(_replicate_all(len(op._schema.returns)))
        return orig(op_schema)
    finally:
        for name, value in saved.items():
            table = getattr(prop, name)
            table.pop(op, None)
            if value is not None:
                table[op] = value


@contextlib.contextmanager
def replicate_fallbacks():
    """Yields a dict op name -> {"schemas", "gathered_bytes", "first"} of
    the ops that ran replicated in the context: how many distinct input
    shardings needed it (DTensor caches a propagation, so repeated calls
    with the same shardings are not seen again), the bytes their gathers
    bring, summed over those, and the first such call's schema."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor

    try:
        from torch.distributed.tensor._sharding_prop import \
            LocalLRUCache as cached
    except ImportError:  # a torch that caches with functools' lru_cache
        def cached(fn):
            return functools.lru_cache(None)(fn)

    prop = DTensor._op_dispatcher.sharding_propagator
    orig = prop.propagate_op_sharding_non_cached  # the bound method
    orig_cached = prop.propagate_op_sharding
    used: Dict[str, Dict] = defaultdict(
        lambda: {"schemas": 0, "gathered_bytes": 0, "first": ""})

    def propagate(op_schema):
        # propagation computes on small real tensors (a strided shard's
        # offsets): outside the fake mode, where they have values
        with unset_fake_temporarily():
            return _propagate(op_schema)

    def _propagate(op_schema):
        try:
            return orig(op_schema)
        except NotImplementedError:
            # a composite op decomposes into ops that may have rules
            if torch._C._dispatch_has_kernel_for_dispatch_key(
                    op_schema.op.name(),
                    torch._C.DispatchKey.CompositeImplicitAutograd):
                raise
        except RuntimeError:
            pass
        out = _replicated(prop, op_schema, orig)
        rec = used[str(op_schema.op)]
        rec["schemas"] += 1
        rec["gathered_bytes"] += _gathered_bytes(op_schema)
        rec["first"] = rec["first"] or str(op_schema)[:400]
        return out

    # DTensor's own arg-max over a sharded dim fails on a mesh whose other
    # dims replicate a batch of 1 (long_500k's decode); without it the op
    # goes through the rules above
    handlers = DTensor._op_dispatcher._custom_op_handlers
    argmax = {op: handlers.pop(op) for op in (torch.ops.aten.argmax.default,
                                              torch.ops.aten.argmin.default)
              if op in handlers}
    prop.propagate_op_sharding_non_cached = propagate
    prop.propagate_op_sharding = cached(propagate)
    try:
        with _real_offsets():
            yield used
    finally:
        del prop.propagate_op_sharding_non_cached  # the class's again
        prop.propagate_op_sharding = orig_cached
        handlers.update(argmax)


@contextlib.contextmanager
def _real_offsets():
    """DTensor's shard offsets computed outside the fake mode."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _utils, placement_types

    _StridedShard = getattr(placement_types, "_StridedShard", None)

    def real(fn):
        def wrapped(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return wrapped

    patches = [(obj, name) for obj, name in (
        (_StridedShard, "local_shard_size_and_offset"),
        (_utils, "_compute_local_shape_and_global_offset"))
        if obj is not None and hasattr(obj, name)]  # as this torch has them
    saved = [getattr(obj, name) for obj, name in patches]
    for (obj, name), fn in zip(patches, saved):
        setattr(obj, name, real(fn))
    try:
        yield
    finally:
        for (obj, name), fn in zip(patches, saved):
            setattr(obj, name, fn)

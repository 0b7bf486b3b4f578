"""The modules a run may not hold: the JAX stack, the JAX package the port
was made from, and its CPU benchmarks. Names are compared by their whole
top-level part, so ``repro_torch`` is allowed and ``repro`` is not."""
from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def forbidden(modules: Iterable[str]) -> List[str]:
    """The forbidden top-level names among ``modules``, sorted."""
    return sorted({m.split(".", 1)[0] for m in modules} & FORBIDDEN)

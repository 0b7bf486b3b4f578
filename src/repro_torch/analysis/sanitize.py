"""Host-sync and in-place sanitizer for the pipeline's steady state (a port
of ``repro.analysis.sanitize``).

The steady state's performance contract is *no host sync on the hot
threads*: the device planes' rollouts never leave the card, the learner
dispatches update i+1 while update i runs, and every sync that does exist
(the shared-memory param publish, the end-of-run metrics drain) is
deliberate and named. A regression — a stray ``.item()``, a tensor built
from a Python value on the card — fails nothing; it quietly serializes
the learner against the card. This module makes it fail loudly instead.

**What the guard means here.** The reference's guard is
``jax.transfer_guard("disallow")``: it refuses *implicit* transfers (a
numpy operand to a device op, a device value read as a Python scalar) and
lets explicit ``device_put``/``device_get`` through. Torch has no implicit
transfers — mixing CPU and CUDA tensors raises, except for 0-dim CPU
scalars — but it reports its *synchronizing* host work: with
``torch.cuda.set_sync_debug_mode("warn")`` each blocking copy from the
card (``.item()``, ``.cpu()``, ``.tolist()``, ``float(t)``), each blocking
copy to it (from pageable memory, or of a Python value:
``torch.tensor(x, device="cuda")``), ``nonzero`` and
``Stream.synchronize`` warns. So the port's guard means **no host sync
that torch reports on this thread inside the scope, except inside an
``allowed`` edge**. That is stricter than the reference in one way (an
explicit ``.cpu()`` is refused where ``device_get`` passes) and looser in
another (a ``non_blocking`` copy, from page-locked or from pageable
memory, is no sync to torch and passes; so do ``torch.cuda.synchronize``
and ``Event.synchronize``, which the mode does not report — the linter's
``hot-path-sync`` rule flags them in ``# hot-path`` functions).

**Per thread.** The sync mode is one process-wide setting of torch's CUDA
layer. A guard arms it: the mode goes to "warn" for the rest of the
sanitized process (``disable_sanitizers`` puts it back), an ``"always"``
filter for torch's sync message goes to the front of the warning filters,
and a hook on ``warnings.showwarning`` decides each sync warning on the
thread that made it: inside a ``guard`` and outside every ``allowed`` it
raises ``HostSyncViolation``, which torch turns into the exception of the
op, so the offending line raises on the guarded thread; inside an
``allowed`` edge it counts the sync against the edge; on any other thread
(an actor's intended read-back) it passes. Every other warning goes on to
the hook installed before. A guard re-arms each time it is entered, and
raises if the card does not take the mode. Without a card there is no
CUDA sync to see: the guards count, and the hook still judges a sync
warning raised by hand (the tests drive it that way).

* :func:`guard` — wraps the steady-state regions: ``PipelinedRL.run``'s
  get → reserve → update → commit block and the device-plane collect
  closures, both from their second call (the first builds the kernels and
  lets cuDNN pick its algorithms, the counterpart of "the first call
  compiles").
* :func:`allowed` — the escape naming an *intended* edge. Each use names
  its edge, so the allowed surface is grep-able and reviewed:
  ``"shm param publish"`` (the process plane's copy of the new params to
  shared memory), ``"replay sample draw"`` (the replay ring's host-side
  draw) and ``"metrics drain"`` (the end-of-run read of the stashed
  metrics).

**The in-place probe.** Torch has no buffer donation, so the reference's
deleted-buffer probe has no literal counterpart; what it stands for — an
alloc-free steady state — is checked on storage instead. The pipeline's
update writes the new params into the reserved ping-pong buffer, so the
published tree's leaves must live in that buffer's storage, leaf by leaf
(``data_ptr`` equal): :func:`assert_deleted` raises ``DonationViolation``
when any is fresh, :func:`assert_uniformly_deleted` only when some are in
place and some fresh (the half-in-place state). ``PipelinedRL.run`` probes
the publish strictly and the learner's own params uniformly (they are new
tensors each update by design: ``repro_torch.pipeline.learner``).

``stats`` counts guarded/allowed/probed activations so tests can pin "the
steady state ran sync-free for >= N iterations" without parsing logs;
``host_syncs`` and ``edge_stats`` count the syncs the hook judged.
"""
from __future__ import annotations

import contextlib
import re
import threading
import warnings
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.analysis import sanitizer_enabled
from repro_torch.utils.tree import tree_leaves

__all__ = [
    "DonationViolation", "HostSyncViolation", "SYNC_MESSAGE", "allowed",
    "assert_deleted", "assert_uniformly_deleted", "deleted_leaves",
    "disarm", "edge_stats", "guard", "host_syncs", "reset_stats", "stats",
    "transfers_enabled",
]

# the text of torch's warning (c10::cuda::warn_or_error_on_sync)
SYNC_MESSAGE = "called a synchronizing CUDA operation"

# activation counters (observability for tests / reports); reset_stats()
# between runs that want per-run numbers
stats: Dict[str, int] = {"guarded": 0, "allowed": 0, "probed": 0}
# the syncs the hook judged: passed on an unguarded thread, absorbed by an
# allowed edge, refused inside a guard
host_syncs: Dict[str, int] = {"unguarded": 0, "allowed": 0, "refused": 0}
# edge name -> [times entered, host syncs absorbed]
edge_stats: Dict[str, List[int]] = {}

_tls = threading.local()
_lock = threading.Lock()
_previous_hook = None  # warnings.showwarning before the hook went in
_cuda_armed = False


class DonationViolation(AssertionError):
    """The update did not write into the buffer it was handed."""


class HostSyncViolation(RuntimeError):
    """A host sync inside a guard scope, outside every allowed edge."""


def transfers_enabled() -> bool:
    return sanitizer_enabled("transfers")


def reset_stats() -> None:
    for d in (stats, host_syncs):
        for k in d:
            d[k] = 0
    with _lock:
        edge_stats.clear()


def _thread():
    st = _tls.__dict__
    if "guard" not in st:
        st["guard"], st["edges"] = 0, []
    return _tls


def _showwarning(message, category, filename, lineno, file=None,
                 line=None):
    if not (issubclass(category, UserWarning)
            and str(message).startswith(SYNC_MESSAGE)):
        _previous_hook(message, category, filename, lineno, file, line)
        return
    st = _thread()
    if st.edges:
        host_syncs["allowed"] += 1
        with _lock:
            edge_stats.setdefault(st.edges[-1], [0, 0])[1] += 1
    elif st.guard:
        host_syncs["refused"] += 1
        raise HostSyncViolation(
            f"disallowed host sync on guarded thread "
            f"{threading.current_thread().name!r} at {filename}:{lineno} "
            f"({message}): the steady state must not wait for the card "
            "here — remove the sync, or name an intended edge with "
            "sanitize.allowed(...)")
    else:
        host_syncs["unguarded"] += 1


def _arm() -> None:
    """Install the hook and the filter (again, if something put its own
    in place since) and set the process's sync mode to "warn" on a card;
    raise when the card does not take it."""
    global _previous_hook, _cuda_armed
    with _lock:
        if warnings.showwarning is not _showwarning:
            _previous_hook = warnings.showwarning
            warnings.showwarning = _showwarning
        first = warnings.filters[0] if warnings.filters else None
        if not (first and first[0] == "always" and first[1] is not None
                and first[1].pattern == re.escape(SYNC_MESSAGE)):
            warnings.filterwarnings("always", message=re.escape(SYNC_MESSAGE),
                                    category=UserWarning)
        if not torch.cuda.is_available():
            return  # no card: no CUDA sync can happen
        if torch.cuda.get_sync_debug_mode() != 1:
            torch.cuda.set_sync_debug_mode("warn")
            if torch.cuda.get_sync_debug_mode() != 1:
                raise RuntimeError("sanitize: torch.cuda.set_sync_debug_mode"
                                   "('warn') did not take; the guard cannot "
                                   "see host syncs")
        _cuda_armed = True


def disarm() -> None:
    """Undo what the guards armed: the sync mode back to "default" and the
    previous warning hook back in place (the filter stays; without the mode
    torch emits no sync warning for it to match)."""
    global _cuda_armed
    with _lock:
        if warnings.showwarning is _showwarning:
            warnings.showwarning = _previous_hook
        if _cuda_armed:
            torch.cuda.set_sync_debug_mode(0)
            _cuda_armed = False


@contextlib.contextmanager
def guard(active: bool = True):
    """Refuse host syncs on this thread inside the scope (no-op when the
    transfers sanitizer is off or ``active`` is False — callers pass
    their own warmed-up predicate so the first call stays exempt)."""
    if not (active and transfers_enabled()):
        yield
        return
    _arm()
    stats["guarded"] += 1
    st = _thread()
    st.guard += 1
    try:
        yield
    finally:
        st.guard -= 1


@contextlib.contextmanager
def allowed(edge: str):
    """Escape hatch naming an intended host sync, inside a guarded region
    or on any other thread. No-op when the sanitizer is off."""
    if not transfers_enabled():
        yield
        return
    stats["allowed"] += 1
    with _lock:
        edge_stats.setdefault(edge, [0, 0])[0] += 1
    st = _thread()
    st.edges.append(edge)
    try:
        yield
    finally:
        st.edges.pop()


def deleted_leaves(tree: Any, into: Any) -> Tuple[list, list]:
    """``(deleted, live)``: the tensor leaves of ``tree`` whose storage the
    matching leaf of ``into`` took over (``data_ptr`` equal: written in
    place, what a donation amounts to), and those it did not. Non-tensor
    leaves are ignored. Unconditional — test helper."""
    a = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    b = [x for x in tree_leaves(into) if isinstance(x, torch.Tensor)]
    if len(a) != len(b):
        raise ValueError(f"probe of a {len(a)}-leaf tree against a "
                         f"{len(b)}-leaf output")
    deleted, live = [], []
    for x, y in zip(a, b):
        (deleted if x.data_ptr() == y.data_ptr() else live).append(x)
    return deleted, live


def assert_deleted(tree: Any, what: str, *, into: Any) -> None:
    """In-place probe: every tensor leaf of ``into`` must live in the
    storage of ``tree``'s leaf at the same position. No-op when the
    transfers sanitizer is off."""
    if not transfers_enabled():
        return
    stats["probed"] += 1
    deleted, live = deleted_leaves(tree, into)
    if live:
        raise DonationViolation(
            f"{what}: {len(live)}/{len(live) + len(deleted)} leaves of the "
            "update's output are fresh tensors, not the buffer handed in — "
            "the write is no longer in place, the alloc-free steady state "
            "is gone")


def assert_uniformly_deleted(tree: Any, what: str, *, into: Any) -> None:
    """In-place *consistency* probe for a tree that may be replaced
    wholesale: all in place and all fresh are both coherent outcomes, but a
    mix means part of the tree was written in place and the rest replaced.
    No-op when the transfers sanitizer is off."""
    if not transfers_enabled():
        return
    stats["probed"] += 1
    deleted, live = deleted_leaves(tree, into)
    if deleted and live:
        raise DonationViolation(
            f"{what}: split update — {len(deleted)} leaf tensor(s) written "
            f"in place but {len(live)} replaced by fresh ones")

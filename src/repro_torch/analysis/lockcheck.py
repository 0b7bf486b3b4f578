"""Runtime lock-order detector for the pipeline's synchronization sites (a
port of ``repro.analysis.lockcheck``; plain threading, so nearly verbatim).

The port holds ten such sites, each built here under the reference's name:
``queue.cond``, ``ring.cond``, ``replay_ring.cond``, ``param_slot.cond``,
``staging_ring.cond``, ``actor.state``, ``quota_ledger.cond``,
``supervisor.lock``, the serving plane's ``slots.cond``, and the
shared-memory param slot's multiprocessing condition
(``shm.param_slot``). They are individually simple, but deadlock is a *global*
property: it needs only two sites acquired in opposite orders by two
threads — the exact class of bug GA3C and Accelerated-Methods report as
their hardest. No test can enumerate interleavings; what a test *can* do
is run the real pipeline once and check the **lock-order graph** it
traced stays acyclic.

Mechanism: every pipeline lock is built through ``make_lock(name)`` /
``make_condition(name)``. Off (the default), the factories return plain
``threading`` primitives — zero overhead. Under ``REPRO_SANITIZE=locks``
they return ``SanitizedLock``/``SanitizedCondition`` wrappers that tell a
process-global :class:`LockOrderMonitor` about every acquire/release/
wait. The monitor keeps:

* a per-thread stack of currently-held locks;
* a directed graph over lock *names* (site identity, not instance — the
  invariant worth checking is "sites of kind A are never taken while
  holding kind B", across all the per-queue/per-slot instances): an edge
  A->B with the acquisition stack that first witnessed it, recorded
  whenever B is acquired while A is held;
* **hazards**: a ``Condition.wait``/``wait_for`` entered while the thread
  holds a *different* lock — the foreign lock stays held for the whole
  (possibly unbounded) wait, the classic lost-wakeup/deadlock shape.

``cycles()`` runs DFS over the name graph; any cycle is a potential
deadlock (two threads can interleave the recorded orders fatally even if
this run got lucky). ``report()`` packages edges/cycles/hazards as a
plain dict; ``PipelinedRL.run`` dumps it through the telemetry hub
(``Telemetry.report("lockcheck", ...)``) at the end of every sanitized
run and the launcher's ``--sanitize locks`` exits non-zero on findings.

Wrappers accept an ``inner`` primitive so non-``threading`` conditions
(the shm slot's ``multiprocessing`` condition) ride the same monitor on
the parent side; a wrapper shipped to a spawned child simply feeds that
child's own (separate, unreported) monitor. Self-edges A->A are reported
as cycles only when two *distinct instances* of a site nest — nesting
the same instance would have deadlocked on the spot already.
"""
from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import sanitizer_enabled

__all__ = [
    "LockOrderMonitor", "SanitizedCondition", "SanitizedLock",
    "locks_enabled", "make_condition", "make_lock", "monitor",
]

_STACK_LIMIT = 12  # frames kept per recorded edge/hazard


def locks_enabled() -> bool:
    return sanitizer_enabled("locks")


def _site_stack() -> List[str]:
    frames = traceback.extract_stack(limit=_STACK_LIMIT + 3)[:-3]
    return [f"{f.filename}:{f.lineno} {f.name}" for f in frames]


class LockOrderMonitor:
    """Process-global lock-order graph fed by the sanitized wrappers."""

    def __init__(self):
        self._mu = threading.Lock()  # raw: guards the graph, never wrapped
        self._tls = threading.local()
        # (held_name, acquired_name) -> {count, distinct, stack, thread}
        self._edges: Dict[Tuple[str, str], dict] = {}
        self._hazards: List[dict] = []

    def _held(self) -> List[Tuple[int, str]]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    # -- wrapper hooks -------------------------------------------------------
    def on_acquire(self, lock_id: int, name: str) -> None:
        held = self._held()
        if held:
            stack = None
            with self._mu:
                for hid, hname in held:
                    e = self._edges.get((hname, name))
                    if e is None:
                        if stack is None:
                            stack = _site_stack()
                        self._edges[(hname, name)] = {
                            "count": 1,
                            "distinct": hid != lock_id,
                            "stack": stack,
                            "thread": threading.current_thread().name,
                        }
                    else:
                        e["count"] += 1
                        e["distinct"] = e["distinct"] or hid != lock_id
        held.append((lock_id, name))

    def on_release(self, lock_id: int, name: str) -> None:
        held = self._held()
        # release order may not be LIFO (bare acquire/release pairs): drop
        # the newest matching entry
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == lock_id:
                del held[i]
                return

    def on_wait(self, lock_id: int, name: str) -> None:
        """A condition wait releases *its own* lock but keeps every other
        held lock pinned for the full (unbounded) wait — record those."""
        foreign = [hname for hid, hname in self._held() if hid != lock_id]
        if foreign:
            with self._mu:
                self._hazards.append({
                    "waiting_on": name,
                    "holding": foreign,
                    "thread": threading.current_thread().name,
                    "stack": _site_stack(),
                })

    # -- analysis ------------------------------------------------------------
    def cycles(self) -> List[List[str]]:
        """Elementary cycles in the name graph (DFS back-edge closure);
        self-loops only when two distinct instances of the site nested."""
        with self._mu:
            graph: Dict[str, set] = {}
            for (a, b), e in self._edges.items():
                if a == b and not e["distinct"]:
                    continue
                graph.setdefault(a, set()).add(b)
        out: List[List[str]] = []
        seen_cycles = set()
        for root in sorted(graph):
            path: List[str] = []
            on_path: Dict[str, int] = {}

            def dfs(node: str) -> None:
                if node in on_path:
                    cyc = path[on_path[node]:] + [node]
                    key = frozenset(cyc)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(cyc)
                    return
                on_path[node] = len(path)
                path.append(node)
                for nxt in sorted(graph.get(node, ())):
                    dfs(nxt)
                path.pop()
                del on_path[node]

            dfs(root)
        return out

    def report(self) -> dict:
        cycles = self.cycles()
        with self._mu:
            edges = [
                {"from": a, "to": b, "count": e["count"],
                 "thread": e["thread"], "stack": e["stack"]}
                for (a, b), e in sorted(self._edges.items())
            ]
            hazards = [dict(h) for h in self._hazards]
        return {"edges": edges, "cycles": cycles, "hazards": hazards}

    def reset(self) -> None:
        """Forget everything (tests; per-thread held stacks of *live*
        threads are intentionally kept — they describe the present)."""
        with self._mu:
            self._edges.clear()
            self._hazards.clear()


_MONITOR = LockOrderMonitor()


def monitor() -> LockOrderMonitor:
    return _MONITOR


class SanitizedLock:
    """``threading.Lock`` look-alike reporting to the global monitor."""

    def __init__(self, name: str, inner=None):
        self._name = name
        self._inner = inner if inner is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _MONITOR.on_acquire(id(self), self._name)
        return got

    def release(self) -> None:
        _MONITOR.on_release(id(self), self._name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"SanitizedLock({self._name!r})"


class SanitizedCondition:
    """``threading.Condition`` look-alike reporting to the monitor.

    ``inner`` may be any condition speaking the stdlib surface —
    including a ``multiprocessing`` condition (the shm param slot), whose
    parent-side acquisition order then lands in the same graph.
    """

    def __init__(self, name: str, inner=None):
        self._name = name
        self._inner = inner if inner is not None else threading.Condition()

    def acquire(self, *args) -> bool:
        got = self._inner.acquire(*args)
        if got:
            _MONITOR.on_acquire(id(self), self._name)
        return got

    def release(self) -> None:
        _MONITOR.on_release(id(self), self._name)
        self._inner.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        _MONITOR.on_wait(id(self), self._name)
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _MONITOR.on_wait(id(self), self._name)
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def __enter__(self) -> "SanitizedCondition":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"SanitizedCondition({self._name!r})"


def make_lock(name: str):
    """A lock for pipeline site ``name``: plain ``threading.Lock`` unless
    ``REPRO_SANITIZE=locks`` is on at construction time."""
    return SanitizedLock(name) if locks_enabled() else threading.Lock()


def make_condition(name: str, inner=None):
    """A condition for pipeline site ``name`` (optionally wrapping a
    caller-built primitive, e.g. a multiprocessing condition)."""
    if locks_enabled():
        return SanitizedCondition(name, inner)
    return inner if inner is not None else threading.Condition()

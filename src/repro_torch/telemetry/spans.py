"""Span recording the hot paths can afford (a copy of ``repro``'s).

One ``SpanEmitter`` per *track* — an actor replica, the learner loop, a
queue plane, a worker subprocess — holding a bounded, preallocated ring of
``(category, t0, t1)`` spans on the monotonic clock (``time.perf_counter``:
CLOCK_MONOTONIC on Linux, so parent- and child-process timestamps share an
epoch; a trace exporter re-anchors shipped spans only when the offset says
otherwise). The design constraints come from where the
recording happens:

* **never blocks** — ``begin``/``end``/``record`` never wait on anything.
  Emitters written from exactly one thread (actors, the learner) take no
  lock at all; multi-producer emitters (a queue's merged put side) take a
  private uncontended ``threading.Lock`` for the duration of two array
  writes.
* **never allocates in steady state** — the ring, the per-category totals
  and the nesting stack are preallocated ``array('d')``/``array('i')``
  storage; recording is index arithmetic and scalar stores. A full ring
  increments ``drops`` and keeps going (the span's *duration* still lands
  in the totals — dropping trace detail must never corrupt the derived
  idle accounting); nesting deeper than ``_MAX_DEPTH`` likewise counts a
  drop instead of growing a stack.
* **totals are the accounting of record** — ``total(cat)`` accumulates
  ``t1 - t0`` per span in record order, the exact float arithmetic the
  pre-telemetry ad-hoc counters (``put_wait_s`` / ``get_wait_s`` /
  ``wait_s``) performed, which is what lets ``RunResult``'s idle fields be
  *derived from* spans without changing a bit of their semantics.

``set_capture(False)`` is the overhead kill switch the
``telemetry_overhead`` benchmark compares against: totals (and therefore
every ``RunResult`` field) keep accumulating, but ring storage,
stack bookkeeping for the watchdog, and last-activity tracking are
skipped — the pre-refactor cost model.
"""
from __future__ import annotations

import threading
import time
from array import array
from typing import List, Optional, Sequence, Tuple

__all__ = [
    "CATEGORIES",
    "COLLECT",
    "QUEUE_PUT_WAIT",
    "QUEUE_GET_WAIT",
    "LEASE",
    "PUBLISH",
    "LEARNER_UPDATE",
    "SHM_COPY",
    "MESH_REASSEMBLE",
    "REPLAY_ADD",
    "REPLAY_SAMPLE",
    "REPLAY_EVICT",
    "FAULT_DETECT",
    "FAULT_RESPAWN",
    "FAULT_GIVEUP",
    "SpanEmitter",
    "set_capture",
    "capture_enabled",
]

# the fixed pipeline vocabulary — every plane speaks these stages (an
# emitter may carry its own table, e.g. the serve launcher's
# prefill/decode, but the pipeline emitters all use this one). The three
# replay.* stages belong to the sampled ReplayRing plane: add (a producer
# deposit), sample (the learner's batched draw over resident slots) and
# evict (FIFO retirement of the oldest slot when the ring is full). The
# three fault.* stages are the supervisor's recovery episodes (detect a
# replica failure, respawn it, or give up and degrade) — appended, never
# reordered: shipped worker rings carry category *indices*, so existing
# entries must keep their positions across versions.
CATEGORIES: Tuple[str, ...] = (
    "collect",
    "queue.put_wait",
    "queue.get_wait",
    "lease",
    "publish",
    "learner.update",
    "shm.copy",
    "mesh.reassemble",
    "replay.add",
    "replay.sample",
    "replay.evict",
    "fault.detect",
    "fault.respawn",
    "fault.giveup",
)
COLLECT = 0
QUEUE_PUT_WAIT = 1
QUEUE_GET_WAIT = 2
LEASE = 3
PUBLISH = 4
LEARNER_UPDATE = 5
SHM_COPY = 6
MESH_REASSEMBLE = 7
REPLAY_ADD = 8
REPLAY_SAMPLE = 9
REPLAY_EVICT = 10
FAULT_DETECT = 11
FAULT_RESPAWN = 12
FAULT_GIVEUP = 13

_MAX_DEPTH = 8  # open-span nesting the preallocated stack covers

# module-global capture switch (ring/stack/activity bookkeeping only —
# totals always accumulate; see module docstring)
_capture = True


def set_capture(enabled: bool) -> None:
    """Globally enable/disable span *capture* (totals always run)."""
    global _capture
    _capture = bool(enabled)


def capture_enabled() -> bool:
    return _capture


class SpanEmitter:
    """Bounded span ring + per-category duration totals for one track.

    Single-writer by default (no lock — actors and the learner each own
    their emitter); pass ``locked=True`` for emitters recorded into from
    several threads at once (a queue's merged producer side). Readers
    (watchdog, heartbeat, trace export) tolerate torn reads: they only run
    for logging/export, never feed the accounting.
    """

    __slots__ = (
        "name", "categories", "capacity", "drops", "count",
        "_cat", "_t0", "_t1", "_totals",
        "_stack_cat", "_stack_t0", "_depth",
        "last_activity", "_lock",
    )

    def __init__(self, name: str, capacity: int = 4096,
                 categories: Sequence[str] = CATEGORIES,
                 locked: bool = False):
        if capacity < 1:
            raise ValueError(f"span ring capacity must be >= 1, got {capacity}")
        self.name = name
        self.categories = tuple(categories)
        self.capacity = capacity
        self.drops = 0  # spans not stored (ring full / stack overflow)
        self.count = 0  # spans stored in the ring
        self._cat = array("i", bytes(4 * capacity))
        self._t0 = array("d", bytes(8 * capacity))
        self._t1 = array("d", bytes(8 * capacity))
        self._totals = array("d", bytes(8 * len(self.categories)))
        self._stack_cat = array("i", bytes(4 * _MAX_DEPTH))
        self._stack_t0 = array("d", bytes(8 * _MAX_DEPTH))
        self._depth = 0
        self.last_activity = 0.0  # perf_counter of the last recorded end
        self._lock = threading.Lock() if locked else None

    # -- hot path ------------------------------------------------------------
    def begin(self, cat: int) -> None:
        """Open a span of ``cat`` (nesting up to ``_MAX_DEPTH``); pair with
        ``end()``. Single-writer only — multi-threaded emitters must use
        ``record`` (there is no per-thread open-span state to share)."""
        d = self._depth
        self._depth = d + 1
        if d < _MAX_DEPTH:
            self._stack_cat[d] = cat
            self._stack_t0[d] = time.perf_counter()
        else:
            self.drops += 1

    def end(self) -> None:
        """Close the innermost open span and record it."""
        d = self._depth - 1
        self._depth = d
        if d < 0 or d >= _MAX_DEPTH:
            return  # over/underflow: the matching begin already counted it
        self._record(self._stack_cat[d], self._stack_t0[d],
                     time.perf_counter())

    def cancel(self) -> None:
        """Close the innermost open span *without* recording it (abort
        paths whose pre-telemetry counters never accumulated either)."""
        self._depth -= 1

    def record(self, cat: int, t0: float, t1: Optional[float] = None) -> None:
        """After-the-fact span (the multi-writer path: ``locked=True``)."""
        if t1 is None:
            t1 = time.perf_counter()
        if self._lock is None:
            self._record(cat, t0, t1)
        else:
            with self._lock:
                self._record(cat, t0, t1)

    def _record(self, cat: int, t0: float, t1: float) -> None:
        # totals first: the accounting of record, immune to ring pressure
        self._totals[cat] += t1 - t0
        if not _capture:
            return
        self.last_activity = t1
        n = self.count
        if n < self.capacity:
            self._cat[n] = cat
            self._t0[n] = t0
            self._t1[n] = t1
            self.count = n + 1
        else:
            self.drops += 1

    # -- derived accounting ----------------------------------------------------
    def total(self, cat: int) -> float:
        """Cumulative duration of ``cat`` spans (drop-proof; see module doc)."""
        return self._totals[cat]

    @property
    def records(self) -> int:
        """Total spans ever recorded (stored + dropped): the progress
        counter the stall watchdog diffs."""
        return self.count + self.drops

    # -- observer side (watchdog / export; tolerates torn reads) -------------
    def current(self) -> Optional[Tuple[str, float]]:
        """(category name, seconds open) of the innermost open span, or
        ``None`` when the track is between spans."""
        d = min(self._depth, _MAX_DEPTH) - 1
        if d < 0:
            return None
        try:
            cat = self._stack_cat[d]
            return self.categories[cat], time.perf_counter() - self._stack_t0[d]
        except IndexError:  # pragma: no cover - raced a concurrent pop
            return None

    def snapshot(self) -> List[Tuple[int, float, float]]:
        """Copy the stored spans out (allocates — end-of-run export only)."""
        n = min(self.count, self.capacity)
        return [(self._cat[i], self._t0[i], self._t1[i]) for i in range(n)]

    def ship(self) -> dict:
        """Picklable export for cross-process transport (worker → parent):
        the ring contents, category table, drop count and a clock sample
        the receiver uses to detect a foreign monotonic epoch."""
        n = min(self.count, self.capacity)
        return {
            "name": self.name,
            "categories": self.categories,
            "cat": self._cat[:n].tolist(),
            "t0": self._t0[:n].tolist(),
            "t1": self._t1[:n].tolist(),
            "drops": self.drops,
            "totals": self._totals.tolist(),
            "clock": time.perf_counter(),
        }

    def reset(self) -> None:
        """Forget everything recorded (workers reset between run commands
        so re-runs don't re-ship old spans)."""
        self.count = 0
        self.drops = 0
        self._depth = 0
        for i in range(len(self._totals)):
            self._totals[i] = 0.0

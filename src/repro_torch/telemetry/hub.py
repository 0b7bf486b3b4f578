"""The per-run telemetry hub: emitter registry, counters, gauges, reports
and the Chrome trace (a port of ``repro.telemetry.hub``).

One ``Telemetry`` per ``PipelinedRL.run``. Every track — the actor
replicas, the learner loop, the trajectory ring — registers its
``SpanEmitter`` here; at run end ``write_trace`` merges them into one
Chrome trace, which shows on a timeline whether the actor threads and the
learner really overlapped. The reference's heartbeat and stall watchdog
threads wait for ROADMAP Queue 1 item 13, and so do the process backend's
shipped worker rings.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.telemetry.spans import CATEGORIES, SpanEmitter
from repro_torch.telemetry.trace import write_chrome_trace
from repro_torch.utils import get_logger

__all__ = ["Telemetry"]

log = get_logger("telemetry")


class Telemetry:
    """Emitter registry, counters, gauges and trace export for one run."""

    def __init__(self):
        self.t0 = time.perf_counter()  # trace epoch
        self._reg_lock = threading.Lock()
        self._tracks: List[Tuple[int, int, Any]] = []  # (pid, tid, emitter)
        self._next_tid: Dict[int, int] = {}
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Any] = {}  # name -> value or callable
        # named end-of-run reports: plain JSON-able dicts, embedded in the
        # trace under "reports"
        self.reports: Dict[str, dict] = {}

    # -- emitters -------------------------------------------------------------
    def emitter(self, name: str, capacity: int = 4096,
                categories: Sequence[str] = CATEGORIES,
                locked: bool = False, pid: int = 0) -> SpanEmitter:
        """Create and register one track's emitter."""
        em = SpanEmitter(name, capacity=capacity, categories=categories,
                         locked=locked)
        self.adopt(em, pid=pid)
        return em

    def adopt(self, emitter: Any, pid: int = 0) -> None:
        """Register an emitter created elsewhere under process track
        ``pid``."""
        with self._reg_lock:
            tid = self._next_tid.get(pid, 1)
            self._next_tid[pid] = tid + 1
            self._tracks.append((pid, tid, emitter))

    def tracks(self) -> List[Tuple[int, int, Any]]:
        with self._reg_lock:
            return list(self._tracks)

    # -- counters / gauges ----------------------------------------------------
    def counter_add(self, name: str, value: float) -> None:
        """Accumulate a monotone counter (single-writer per name)."""
        self._counters[name] = self._counters.get(name, 0.0) + value

    def counter(self, name: str) -> float:
        return self._counters.get(name, 0.0)

    def set_gauge(self, name: str, value: Any) -> None:
        """Register a gauge: a value, or a zero-arg callable sampled when
        read (cheap and thread-safe, e.g. ``ring.qsize``)."""
        self._gauges[name] = value

    def gauges(self) -> Dict[str, Any]:
        """Every gauge's current value (callables are sampled now)."""
        return {name: v() if callable(v) else v
                for name, v in list(self._gauges.items())}

    # -- named reports --------------------------------------------------------
    def report(self, name: str, payload: dict) -> None:
        """Attach a named end-of-run report (overwrites a prior ``name``);
        harnesses read ``hub.reports[name]`` after ``run()`` returns."""
        self.reports[name] = payload

    # -- trace export ---------------------------------------------------------
    def write_trace(self, path) -> int:
        """Merge every registered track into one Chrome trace JSON; returns
        the number of spans written."""
        n = write_chrome_trace(path, self.tracks(), self.t0,
                               reports=self.reports or None)
        if isinstance(path, str):
            log.info("telemetry: wrote %d spans to %s", n, path)
        return n

    def stop(self) -> None:
        """End of run. The hub runs no observer thread yet (the heartbeat
        and the watchdog are ROADMAP Queue 1 item 13), so there is nothing
        to join; kept so the run loop's teardown reads as the reference's."""

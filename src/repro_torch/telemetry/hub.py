"""The per-run telemetry hub: emitter registry, counters, gauges, reports,
the Chrome trace, the heartbeat and the stall watchdog (a port of
``repro.telemetry.hub``).

One ``Telemetry`` per ``PipelinedRL.run``. Every track — the actor
replicas, the learner loop, the trajectory ring or queue — registers its
``SpanEmitter`` here; at run end ``write_trace`` merges them into one
Chrome trace, which shows on a timeline whether the actor threads and the
learner really overlapped. During the run two optional daemon threads
observe them:

* **heartbeat** (``metrics_jsonl``): every ``interval`` seconds, append
  one JSON line of liveness metrics — steps/s EMA, queue depth, latest
  staleness, per-actor seconds since last activity, cumulative span drops.
  One line per tick, flushed, so ``tail -f`` on a live run (or a
  post-mortem on a dead one) always has current numbers.
* **stall watchdog** (``stall_timeout_s``): when any watched party (the
  learner or an actor) records no span for a full window, log *which
  stage every party is currently blocked in* — the difference between
  "it hangs" and "actor 2 is stuck in queue.put_wait, so the learner
  died" — instead of hanging silently. Logs once per stall episode;
  re-arms when progress resumes. An external env that hangs or runs slow
  shows here.

A process worker records its spans in its own interpreter and ships
the ring (``SpanEmitter.ship()``) with the terminal message of each run;
``merge_shipped`` adopts it as a ``ShippedTrack`` under the worker's own
process track. Observer threads only read emitter state that tolerates
torn reads (they feed logs, never the accounting), so the hot paths stay
lock-free.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.telemetry.spans import CATEGORIES, SpanEmitter
from repro_torch.telemetry.trace import write_chrome_trace
from repro_torch.utils import get_logger

__all__ = ["Telemetry", "ShippedTrack"]

log = get_logger("telemetry")

# a shipped clock sample further than this from our own monotonic clock
# means the child ran on a different epoch (non-Linux perf_counter):
# re-anchor its spans at receive time. On Linux both processes read
# CLOCK_MONOTONIC, the offset is ~transport latency, and the timestamps
# stay untouched.
_EPOCH_SLACK_S = 1.0


class ShippedTrack:
    """Read-only emitter stand-in rebuilt from ``SpanEmitter.ship()``."""

    def __init__(self, payload: dict, offset: float = 0.0):
        self.name = payload["name"]
        self.categories = tuple(payload["categories"])
        self.drops = payload["drops"]
        self._spans = [
            (c, t0 + offset, t1 + offset)
            for c, t0, t1 in zip(payload["cat"], payload["t0"], payload["t1"])
        ]
        self._totals = list(payload["totals"])

    def snapshot(self) -> List[Tuple[int, float, float]]:
        return list(self._spans)

    def total(self, cat: int) -> float:
        return self._totals[cat]


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
        self._hb_stop: Optional[threading.Event] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._wd_stop: Optional[threading.Event] = None
        self._wd_thread: Optional[threading.Thread] = None

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

    def merge_shipped(self, payload: dict, pid: int) -> ShippedTrack:
        """Adopt a worker-side ring shipped through the ready queue under
        process track ``pid`` (``actor_id + 1``)."""
        offset = time.perf_counter() - payload["clock"]
        track = ShippedTrack(
            payload, offset=offset if abs(offset) > _EPOCH_SLACK_S else 0.0)
        self.adopt(track, pid=pid)
        return track

    def tracks(self) -> List[Tuple[int, int, Any]]:
        with self._reg_lock:
            return list(self._tracks)

    def drops(self) -> int:
        return sum(em.drops for _, _, em in self.tracks())

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
        """Every gauge's current value (callables are sampled now); a gauge
        that raises reads ``None`` — it must never kill the heartbeat."""
        out = {}
        for name, v in list(self._gauges.items()):
            try:
                out[name] = v() if callable(v) else v
            except Exception:
                out[name] = None
        return out

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

    # -- heartbeat ------------------------------------------------------------
    def heartbeat_start(self, path: str, interval: float = 1.0,
                        actor_emitters: Sequence[SpanEmitter] = ()) -> None:
        """Append one JSONL metrics line to ``path`` every ``interval`` s,
        and a last one on stop."""
        if self._hb_thread is not None:
            raise RuntimeError("heartbeat already running")
        stop = threading.Event()
        actors = list(actor_emitters)

        def loop():
            ema = 0.0
            last_steps = self.counter("steps")
            last_t = time.perf_counter()
            with open(path, "a") as f:
                while True:
                    stopped = stop.wait(interval)
                    now = time.perf_counter()
                    steps = self.counter("steps")
                    dt = max(now - last_t, 1e-9)
                    inst = (steps - last_steps) / dt
                    # EMA over ticks: alpha=0.5 tracks fast, smooths jitter
                    ema = inst if ema == 0.0 else 0.5 * inst + 0.5 * ema
                    last_steps, last_t = steps, now
                    line = {
                        "time_unix": time.time(),
                        "uptime_s": now - self.t0,
                        "steps": steps,
                        "steps_per_s_ema": ema,
                        "span_drops": self.drops(),
                        "actor_last_activity_s": {
                            em.name: (round(now - em.last_activity, 6)
                                      if em.last_activity else None)
                            for em in actors
                        },
                        # every other registered counter — additive: schema
                        # consumers key on the fields above
                        "counters": {k: v for k, v in self._counters.items()
                                     if k != "steps"},
                    }
                    line.update(self.gauges())
                    f.write(json.dumps(line) + "\n")
                    f.flush()
                    if stopped:
                        return  # final line written on stop

        self._hb_stop = stop
        self._hb_thread = threading.Thread(
            target=loop, name="telemetry-heartbeat", daemon=True)
        self._hb_thread.start()

    def heartbeat_stop(self) -> None:
        if self._hb_thread is None:
            return
        self._hb_stop.set()
        self._hb_thread.join(timeout=10.0)
        self._hb_thread = self._hb_stop = None

    # -- stall watchdog -------------------------------------------------------
    def watchdog_start(
        self,
        window_s: float,
        parties: Sequence[Tuple[str, SpanEmitter,
                                Optional[Callable[[], bool]]]],
    ) -> None:
        """Watch ``parties`` = (label, emitter, alive_fn) for progress.

        A party has made progress when its emitter recorded any span since
        the last check; one that is still alive (``alive_fn`` — ``None``
        means always) but has recorded nothing for ``window_s`` is stalled.
        While any party is stalled, log every party's current stage once
        per episode — then stay quiet until progress resumes.
        """
        if self._wd_thread is not None:
            raise RuntimeError("watchdog already running")
        if window_s <= 0:
            raise ValueError(f"watchdog window must be > 0, got {window_s}")
        stop = threading.Event()
        watched = list(parties)

        def loop():
            last = {label: (em.records, time.perf_counter())
                    for label, em, _ in watched}
            reported = False
            while not stop.wait(min(window_s / 4.0, 1.0)):
                now = time.perf_counter()
                stalled = []
                for label, em, alive in watched:
                    recs, since = last[label]
                    if em.records != recs:
                        last[label] = (em.records, now)
                        continue
                    if now - since >= window_s and (alive is None or alive()):
                        stalled.append(label)
                if not stalled:
                    reported = False
                    continue
                if reported:
                    continue  # one report per stall episode
                reported = True
                stages = []
                for label, em, alive in watched:
                    cur = em.current()
                    if cur is not None:
                        stages.append(f"{label}: blocked in {cur[0]}"
                                      f" for {cur[1]:.1f}s")
                    elif alive is not None and not alive():
                        stages.append(f"{label}: exited")
                    else:
                        stages.append(f"{label}: idle (no open span)")
                log.warning(
                    "stall watchdog: no progress from %s for %.1fs — %s",
                    ", ".join(stalled), window_s, "; ".join(stages))

        self._wd_stop = stop
        self._wd_thread = threading.Thread(
            target=loop, name="telemetry-watchdog", daemon=True)
        self._wd_thread.start()

    def watchdog_stop(self) -> None:
        if self._wd_thread is None:
            return
        self._wd_stop.set()
        self._wd_thread.join(timeout=10.0)
        self._wd_thread = self._wd_stop = None

    def stop(self) -> None:
        """Stop both observer threads (idempotent; run-exit path)."""
        self.heartbeat_stop()
        self.watchdog_stop()

"""Chrome trace-event JSON export (the ``--trace PATH`` artifact), a copy
of ``repro``'s.

The format is the Trace Event Format's JSON Object Format — a
``traceEvents`` list of complete-duration (``"ph": "X"``) events plus
metadata (``"ph": "M"``) events naming each process/thread track — which
``chrome://tracing`` and Perfetto (https://ui.perfetto.dev) open directly.

Track mapping: ``pid`` is the execution plane's process (0 = the parent;
worker subprocesses get ``actor_id + 1``), ``tid`` one emitter within it
(an actor replica, the learner loop, a queue plane). Timestamps are
microseconds relative to the run's epoch (the ``Telemetry`` hub's t0), so
the trace starts near 0 regardless of host uptime.
"""
from __future__ import annotations

import json
from typing import List, Optional, Tuple

__all__ = ["write_chrome_trace"]


def write_chrome_trace(path_or_file, tracks: List[Tuple[int, int, object]],
                       epoch: float, reports: Optional[dict] = None) -> int:
    """Write one merged Chrome trace; returns the number of span events.

    ``tracks`` is ``[(pid, tid, emitter), ...]`` (emitters or anything with
    ``name``/``categories``/``snapshot()``); ``epoch`` the perf_counter
    origin subtracted from every timestamp. ``reports`` (optional) is a
    dict of named end-of-run payloads (e.g. the lock-order sanitizer's
    verdict) embedded verbatim as a top-level ``"reports"`` key — trace
    viewers ignore unknown keys, post-mortem tooling greps them.
    """
    events = []
    pids_named = set()
    for pid, tid, em in tracks:
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": em.name},
        })
        if pid not in pids_named:
            pids_named.add(pid)
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": "parent" if pid == 0
                         else f"worker{pid - 1}"},
            })
    n_spans = 0
    for pid, tid, em in tracks:
        cats = em.categories
        for cat, t0, t1 in em.snapshot():
            events.append({
                "name": cats[cat],
                "cat": cats[cat],
                "ph": "X",
                "ts": (t0 - epoch) * 1e6,
                "dur": (t1 - t0) * 1e6,
                "pid": pid,
                "tid": tid,
            })
            n_spans += 1
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    if reports:
        payload["reports"] = reports
    if hasattr(path_or_file, "write"):
        json.dump(payload, path_or_file)
    else:
        with open(path_or_file, "w") as f:
            json.dump(payload, f)
    return n_spans

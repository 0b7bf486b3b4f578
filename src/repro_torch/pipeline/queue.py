"""Bounded FIFO between producers and one consumer (the serving plane's
admission queue), a copy of ``repro.pipeline.queue.TrajectoryQueue``.

A condition-variable FIFO with the properties the pipeline needs beyond the
stdlib ``queue.Queue``:

* **backpressure accounting** — the cumulative time producers spent
  blocked on a full queue and the consumer spent blocked on an empty one,
  recorded as ``queue.put_wait``/``queue.get_wait`` spans into the queue's
  ``SpanEmitter``; ``put_wait_s``/``get_wait_s`` read its totals.
* **never drops** — depth bounds memory by blocking producers, not by
  discarding payloads.
* **multi-producer shutdown** — with ``producers=N``, each producer calls
  ``producer_done()`` when it finishes; the stream closes after the last
  one. ``close()`` is the hard abort: a producer blocked in ``put()``
  raises ``QueueClosed`` promptly, and the consumer sees ``CLOSED`` after
  draining.

The reference's lock-order sanitizer (``make_condition``) and its check
that no mesh-sharded JAX array rides the host queue have no counterpart
here: this queue uses a plain ``threading.Condition``.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from typing import Any, Optional

from repro_torch.telemetry.spans import (QUEUE_GET_WAIT, QUEUE_PUT_WAIT,
                                         SpanEmitter)


class Closed:
    """Sentinel delivered to a consumer after the stream closes and drains."""


CLOSED = Closed()


class QueueClosed(RuntimeError):
    """Raised by ``put()`` on a closed queue — including a put that was
    already blocked when ``close()`` landed."""


class TrajectoryQueue:
    """Bounded FIFO of payloads with idle-time accounting."""

    def __init__(self, depth: int = 2, producers: int = 1,
                 name: str = "queue"):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        if producers < 1:
            raise ValueError(f"producers must be >= 1, got {producers}")
        self.depth = depth
        self._items: deque = deque()
        self._cond = threading.Condition()
        self._producers_left = producers
        self._closed = False
        self.span_emitter = SpanEmitter(name, locked=True)

    @property
    def put_wait_s(self) -> float:
        """Producers idle (queue full), all producers merged."""
        return self.span_emitter.total(QUEUE_PUT_WAIT)

    @property
    def get_wait_s(self) -> float:
        """Consumer idle (queue empty)."""
        return self.span_emitter.total(QUEUE_GET_WAIT)

    # hot-path
    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        """Blocking put; accumulates the time spent waiting on a full queue.

        Raises ``QueueClosed`` if the queue is (or becomes, while blocked)
        closed, and stdlib ``queue.Full`` when ``timeout`` elapses first.
        """
        t0 = time.perf_counter()
        try:
            with self._cond:
                ok = self._cond.wait_for(
                    lambda: self._closed or len(self._items) < self.depth,
                    timeout=timeout,
                )
                if self._closed:
                    raise QueueClosed("put() on a closed TrajectoryQueue")
                if not ok:
                    raise _queue.Full
                self._items.append(item)
                self._cond.notify_all()
        finally:
            self.span_emitter.record(QUEUE_PUT_WAIT, t0)

    # hot-path
    def get(self, timeout: Optional[float] = None) -> Any:
        """Blocking get; returns ``CLOSED`` once closed and drained.
        Raises stdlib ``queue.Empty`` when ``timeout`` elapses first."""
        t0 = time.perf_counter()
        try:
            with self._cond:
                if not self._cond.wait_for(
                    lambda: self._items or self._closed, timeout=timeout
                ):
                    raise _queue.Empty
                if self._items:
                    item = self._items.popleft()
                    self._cond.notify_all()
                    return item
                return CLOSED
        finally:
            self.span_emitter.record(QUEUE_GET_WAIT, t0)

    def producer_done(self) -> None:
        """One producer finished; closes the stream when the last producer
        checks out (the consumer drains, then sees ``CLOSED``)."""
        with self._cond:
            self._producers_left -= 1
            if self._producers_left <= 0:
                self._closed = True
            self._cond.notify_all()

    def close(self) -> None:
        """Hard abort: wakes blocked producers (``QueueClosed``) and the
        consumer (``CLOSED`` after the remaining items). Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def qsize(self) -> int:
        with self._cond:
            return len(self._items)

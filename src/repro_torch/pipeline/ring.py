"""Device-resident trajectory ring — the pipeline's device plane (a port of
``repro.pipeline.ring.DeviceTrajectoryRing``).

A bounded ring of ``depth`` slots whose payloads are tensors on one device
end to end. Producers (actor threads) deposit their collected ``Rollout``
into a slot; the consumer (the learner) takes slots in ticket order with
**sole ownership** — ``get()`` clears the ring's reference, so once the
learner drops the payload its memory returns to the caching allocator
for the next collect instead of lingering behind a ring reference.
Nothing crosses to the host at any point.

Ordering and shutdown semantics are identical to ``TrajectoryQueue`` (same
``put``/``get``/``producer_done``/``close``/idle-accounting surface, same
``CLOSED``/``QueueClosed``/``queue.Full`` signals). Every accepted ``put``
is stamped with a monotonically increasing *ticket*; the consumer drains in
ticket order, which is arrival order — multi-producer FIFO, never dropping.

The ring enforces its plane: every tensor of a payload must live on the
ring's ``device``. A tensor elsewhere (a CPU tensor on a CUDA ring) or a
numpy array means a host staging step crept in, and raises ``TypeError``
at once rather than silently adding a round trip.

On the card a payload is written on the actor's CUDA stream and read on
the learner's. ``adopt`` makes that handoff safe: the learner's stream
waits on the payload's ``ready`` event, and every payload tensor is
``record_stream``-ed onto the learner's stream, so the caching allocator
cannot hand the actor's memory out again while the update still reads it.

The reference's ``MeshTrajectoryRing`` waits for ROADMAP Queue 1 item 14.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Any, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.pipeline.queue import CLOSED, QueueClosed
from repro_torch.telemetry.spans import (QUEUE_GET_WAIT, QUEUE_PUT_WAIT,
                                         SpanEmitter)

__all__ = ["DeviceTrajectoryRing", "adopt"]


class _Slot:
    """One preallocated ring slot: a payload reference plus its ticket tag."""

    __slots__ = ("payload", "ticket", "full")

    def __init__(self):
        self.payload: Any = None
        self.ticket: int = -1
        self.full: bool = False


def _leaves(payload) -> Iterator:
    """Every leaf of a payload: tuples (``Rollout``, ``Transition``), lists
    and dicts are walked; anything else is a leaf."""
    if isinstance(payload, (tuple, list)):
        for x in payload:
            yield from _leaves(x)
    elif isinstance(payload, dict):
        for x in payload.values():
            yield from _leaves(x)
    else:
        yield payload


def _on(device: torch.device, ring: torch.device) -> bool:
    return device.type == ring.type and (ring.index is None
                                         or device.index == ring.index)


def _assert_on_device(payload, device: torch.device,
                      plane: str = "DeviceTrajectoryRing") -> None:
    """Reject numpy leaves and tensors on another device. Non-tensor
    metadata (ints, callables, CUDA events) rides along untouched."""
    for leaf in _leaves(payload):
        if isinstance(leaf, (np.ndarray, np.generic)):
            raise TypeError(
                f"{plane} payloads must be tensors on the ring's device "
                f"{device}; got a numpy {type(leaf).__name__} — a host "
                "staging step crept into the device plane")
        if isinstance(leaf, torch.Tensor) and not _on(leaf.device, device):
            raise TypeError(
                f"{plane} payloads must be tensors on the ring's device "
                f"{device}; got one on {leaf.device}")


def adopt(payload, stream) -> None:
    """Make a ring payload safe to read on the consumer's CUDA ``stream``:
    the stream waits on the payload's ``ready`` event (recorded on the
    producer's stream after the collect), and every payload tensor is
    ``record_stream``-ed onto it, so its memory is not reused before the
    work queued there has read it. ``stream=None`` (the CPU) does nothing."""
    if stream is None:
        return
    ready = getattr(payload, "ready", None)
    if ready is not None:
        stream.wait_event(ready)
    for leaf in _leaves(payload):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            leaf.record_stream(stream)


class DeviceTrajectoryRing:
    """Bounded multi-producer ring of on-device rollout slots.

    Drop-in for ``TrajectoryQueue`` on the device plane: same blocking
    ``put``/``get`` with idle-time accounting, same multi-producer
    ``producer_done`` refcounted shutdown and hard ``close()`` abort. Depth
    bounds device memory (at most ``depth`` rollouts in flight); every
    accepted put is ticket-stamped and consumed exactly once, in order.
    """

    def __init__(self, depth: int = 2, producers: int = 1, telemetry=None,
                 name: str = "ring", device="cuda"):
        if depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {depth}")
        if producers < 1:
            raise ValueError(f"producers must be >= 1, got {producers}")
        self.depth = depth
        self.device = torch.device(device)
        self._slots: List[_Slot] = [_Slot() for _ in range(depth)]
        self._tail = 0  # next ticket to issue (producer side)
        self._head = 0  # next ticket to consume (learner side)
        self._cond = threading.Condition()
        self._producers_left = producers
        self._closed = False
        # span-derived idle accounting: every put/get records its full
        # duration into the ring's track; put_wait_s/get_wait_s read totals
        if telemetry is not None:
            self.span_emitter = telemetry.emitter(name, locked=True)
        else:
            self.span_emitter = SpanEmitter(name, locked=True)

    @property
    def put_wait_s(self) -> float:
        """Producers idle (ring full), all actors merged — span-derived."""
        return self.span_emitter.total(QUEUE_PUT_WAIT)

    @property
    def get_wait_s(self) -> float:
        """Learner idle (ring empty) — span-derived."""
        return self.span_emitter.total(QUEUE_GET_WAIT)

    # -- producer side -------------------------------------------------------
    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        """Deposit a payload that lives on the ring's device into the next
        free slot.

        Blocks while all ``depth`` slots are live (backpressure — the memory
        bound), accumulating producer idle time. Raises ``QueueClosed`` if
        the ring is (or becomes, while blocked) closed, stdlib ``queue.Full``
        on timeout, and ``TypeError`` for a payload off the ring's device.
        """
        _assert_on_device(item, self.device)
        t0 = time.perf_counter()
        try:
            with self._cond:
                ok = self._cond.wait_for(
                    lambda: self._closed or self._tail - self._head < self.depth,
                    timeout=timeout)
                if self._closed:
                    raise QueueClosed("put() on a closed DeviceTrajectoryRing")
                if not ok:
                    raise _queue.Full
                ticket = self._tail
                self._tail = ticket + 1
                slot = self._slots[ticket % self.depth]
                assert not slot.full, "ring invariant: issued slot must be free"
                slot.payload = item
                slot.ticket = ticket
                slot.full = True
                self._cond.notify_all()
        finally:
            self.span_emitter.record(QUEUE_PUT_WAIT, t0)

    # -- consumer side -------------------------------------------------------
    def get(self, timeout: Optional[float] = None) -> Any:
        """Take the oldest full slot's payload, transferring ownership.

        The slot's reference is cleared before returning, so the caller is
        the payload's sole owner. Returns ``CLOSED`` once closed and
        drained; raises stdlib ``queue.Empty`` on timeout.
        """
        t0 = time.perf_counter()
        try:
            with self._cond:
                if not self._cond.wait_for(
                        lambda: self._slots[self._head % self.depth].full
                        or self._closed, timeout=timeout):
                    raise _queue.Empty
                slot = self._slots[self._head % self.depth]
                if not slot.full:
                    return CLOSED
                item = slot.payload
                # ownership transfer: drop the ring's reference
                slot.payload = None
                slot.ticket = -1
                slot.full = False
                self._head += 1
                self._cond.notify_all()
                return item
        finally:
            self.span_emitter.record(QUEUE_GET_WAIT, t0)

    # -- shutdown (same protocol as TrajectoryQueue) -------------------------
    def producer_done(self) -> None:
        """One producer finished its quota; the stream closes when the last
        producer checks out (the consumer drains, then sees ``CLOSED``)."""
        with self._cond:
            self._producers_left -= 1
            if self._producers_left <= 0:
                self._closed = True
            self._cond.notify_all()

    def close(self) -> None:
        """Hard abort: wakes blocked producers (``QueueClosed``) and the
        consumer (``CLOSED`` after the remaining slots drain). Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def qsize(self) -> int:
        with self._cond:
            return self._tail - self._head

    @property
    def tickets_issued(self) -> int:
        """Total puts accepted over the ring's lifetime (monotone)."""
        with self._cond:
            return self._tail

    @property
    def tickets_consumed(self) -> int:
        """Total gets delivered over the ring's lifetime (monotone)."""
        with self._cond:
            return self._head

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

With a rollout mesh (``repro_torch.launch.mesh``) the ring grows per-lane
sub-rings (``MeshTrajectoryRing``): one single-producer
``DeviceTrajectoryRing`` a lane, on the lane's device, fed by the actor
lane pinned there, and a ``get()`` that takes one seq-aligned rollout
from *every* lane and returns them as one payload whose fields are
``Lanes`` — the lanes' own tensors in lane order, never concatenated:
the reference's zero-copy global array becomes the list of its shards,
and the sharded learner step reads each on its own device. Nothing is
copied and nothing crosses to the host on that path.
"""
from __future__ import annotations

import queue as _queue
import time
from typing import Any, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.analysis.lockcheck import make_condition
from repro_torch.pipeline.queue import CLOSED, Lanes, QueueClosed
from repro_torch.telemetry.spans import (MESH_REASSEMBLE, QUEUE_GET_WAIT,
                                         QUEUE_PUT_WAIT, SpanEmitter)

__all__ = ["DeviceTrajectoryRing", "Lanes", "MeshTrajectoryRing", "adopt"]


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
    # the CPU is one device: a CPU tensor's device never carries the index
    # a ``cpu:0`` ring may name
    return device.type == ring.type and (ring.index is None
                                         or device.type == "cpu"
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
    work queued there has read it. A mesh payload (its fields ``Lanes``)
    takes one stream a lane, and lane ``i``'s part is adopted on
    ``stream[i]``. A stream ``None`` (the CPU) does nothing."""
    if isinstance(getattr(payload, "traj", None), Lanes):
        for part, ready, s in zip(zip(payload.traj, payload.last_obs),
                                  payload.ready, stream):
            _adopt(part, ready, s)
    else:
        _adopt(payload, getattr(payload, "ready", None), stream)


def _adopt(payload, ready, stream) -> None:
    if stream is None:
        return
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
        self._cond = make_condition("ring.cond")
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
    # hot-path
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
    # hot-path
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


# ---------------------------------------------------------------------------
# Mesh plane — per-lane sub-rings feeding the sharded learner step
# ---------------------------------------------------------------------------


class _MeshLane:
    """One actor lane's view of a ``MeshTrajectoryRing``: the producer
    half of the queue surface (``put``/``producer_done``/``close``) bound
    to the lane's sub-ring, so ``ActorThread`` drives a lane as any other
    plane. ``put`` names the lane when a payload tensor lives off the
    lane's device (a mis-pinned actor state) or is a numpy array."""

    def __init__(self, ring: "MeshTrajectoryRing", index: int, device):
        self._ring = ring
        self._sub = ring._subs[index]
        self._index = index
        self.device = device

    # hot-path
    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        _assert_on_device(item, self.device,
                          plane=f"mesh lane {self._index}")
        self._sub.put(item, timeout=timeout)

    def producer_done(self) -> None:
        self._sub.producer_done()

    def close(self) -> None:
        # a dead lane ends the stream: no batch can be complete without it
        self._ring.close()

    @property
    def put_wait_s(self) -> float:
        return self._sub.put_wait_s


class MeshTrajectoryRing:
    """Per-lane sub-rings and the lanes' payload set: the mesh queue plane.

    One single-producer ``DeviceTrajectoryRing`` a lane of a 1-axis
    ``("data",)`` ``RolloutMesh`` (``repro_torch.launch.mesh``), each on
    its lane's device (their conditions are the ring's lock site,
    ``ring.cond``). Actor lane ``i`` produces into ``lane(i)``; ``get()``
    takes the oldest payload of *every* lane and returns one ``Rollout``
    whose ``traj``, ``last_obs`` and ``ready`` are ``Lanes`` of the lanes'
    own objects in lane order, with ``actor_id=-1`` (mesh-global), the
    lanes' common seq and the *minimum* behaviour version (staleness
    reports the worst lane). Every lane must produce the same shapes.
    Backpressure is per lane; ``close()`` aborts every lane, and the
    stream ends (``CLOSED``) once any lane is closed and drained — a
    partial set can never be learned.
    """

    def __init__(self, depth: int, mesh, telemetry=None):
        if tuple(mesh.axis_names) != ("data",):
            raise ValueError(
                "MeshTrajectoryRing needs a 1-axis ('data',) rollout mesh "
                f"(make_rollout_mesh), got axes {tuple(mesh.axis_names)}")
        self.mesh = mesh
        self.devices = list(mesh.devices)
        self.depth = depth
        self._subs = [DeviceTrajectoryRing(depth, producers=1,
                                           telemetry=telemetry,
                                           name=f"mesh.lane{i}", device=d)
                      for i, d in enumerate(self.devices)]
        self._lanes = [_MeshLane(self, i, d)
                       for i, d in enumerate(self.devices)]
        # lanes already taken for a set whose later lanes timed out: the
        # next get() (one consumer) resumes them, so a timeout never loses
        # a lane's payload nor shifts the lanes' seqs against each other
        self._pending: List[Any] = []
        # the consumer's track (one writer, no lock): the whole get as
        # queue.get_wait, the set's assembly nested as mesh.reassemble
        self.span_emitter = (telemetry.emitter("mesh") if telemetry
                             is not None else SpanEmitter("mesh"))

    def lane(self, i: int) -> _MeshLane:
        """The producer facade actor lane ``i`` drives (device ``i``)."""
        return self._lanes[i]

    @property
    def get_wait_s(self) -> float:
        """Learner idle (some lane empty) — span-derived."""
        return self.span_emitter.total(QUEUE_GET_WAIT)

    def qsize(self) -> int:
        """Complete sets ready (the fewest over the lanes)."""
        return min(s.qsize() for s in self._subs)

    @property
    def tickets_issued(self) -> List[int]:
        """Accepted puts, a count a lane (the never-drop audit)."""
        return [s.tickets_issued for s in self._subs]

    @property
    def tickets_consumed(self) -> List[int]:
        return [s.tickets_consumed for s in self._subs]

    @staticmethod
    def _assemble(parts: List[Any]):
        from repro_torch.pipeline.actor import Rollout

        seqs = [p.seq for p in parts]
        if len(set(seqs)) != 1:
            raise RuntimeError(
                f"mesh lanes desynchronized: per-lane seqs {seqs} — each "
                "lane must contribute exactly one rollout per update")
        return Rollout(
            traj=Lanes(p.traj for p in parts),
            last_obs=Lanes(p.last_obs for p in parts),
            behavior_version=min(p.behavior_version for p in parts),
            actor_id=-1,  # mesh-global: one rollout of every lane
            seq=seqs[0],
            release=None,  # device plane: dropping the payload frees it
            ready=Lanes(p.ready for p in parts))

    # hot-path
    def get(self, timeout: Optional[float] = None) -> Any:
        """One ``Rollout`` of ``Lanes``, each lane's oldest payload.

        Blocks until *every* lane has one (the sharded step needs all
        shards). Returns ``CLOSED`` once any lane is closed and drained;
        raises stdlib ``queue.Empty`` on timeout (lanes already taken wait
        in ``_pending`` for the next call).
        """
        self.span_emitter.begin(QUEUE_GET_WAIT)
        try:
            deadline = None if timeout is None else time.perf_counter() + \
                timeout
            parts = self._pending
            for sub in self._subs[len(parts):]:
                left = (None if deadline is None
                        else max(deadline - time.perf_counter(), 0.0))
                item = sub.get(timeout=left)
                if item is CLOSED:
                    self.close()  # no lane can complete a set any more
                    self._pending = []
                    return CLOSED
                parts.append(item)
            self._pending = []
            self.span_emitter.begin(MESH_REASSEMBLE)
            try:
                return self._assemble(parts)
            finally:
                self.span_emitter.end()
        finally:
            self.span_emitter.end()

    def producer_done(self) -> None:
        raise RuntimeError(
            "producer_done() on the mesh ring itself — actors check out "
            "through their lane: ring.lane(i).producer_done()")

    def close(self) -> None:
        """Hard abort: closes every lane's sub-ring. Idempotent."""
        for sub in self._subs:
            sub.close()


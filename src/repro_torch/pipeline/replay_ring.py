"""Device-resident sampled replay ring — the pipeline's off-policy plane (a
port of ``repro.pipeline.replay_ring``).

``DeviceTrajectoryRing`` is a FIFO: every payload is consumed exactly once,
in ticket order, and a full ring *blocks* its producers (backpressure is
the staleness bound for on-policy learners). Off-policy algorithms invert
both halves of that contract: the learner wants to *sample* — uniformly or
by priority — over a window of past rollouts, reusing each many times, and
a slow learner must never throttle acting (Mnih et al. 2015, Horgan et
al. 2018).

``ReplayRing`` is the FIFO ring's sampled twin, keeping what made the
device plane safe and changing exactly those two contract points:

* **same plane, same policing** — payloads are tensors on the ring's
  device end to end (a numpy leaf, or a CPU tensor on a CUDA ring, raises
  ``TypeError`` at ``put``), slots are preallocated references, and
  device memory is bounded at ``capacity`` resident rollouts.
* **never-drop means never-block** — ``put`` on a full ring *evicts* the
  oldest resident slot (FIFO by ticket) instead of blocking: the ring
  drops its *oldest memory*, never the producer's *stream*. Every accepted
  put is still ticket-stamped (tickets are the eviction order and the
  freshness accounting).
* **sampled get, retained slots** — ``sample`` draws ``batch`` resident
  slots (with replacement; uniform, or ∝ priority with
  ``prioritized=True``) and *retains* them: slots are reused across
  updates and retired only by eviction or shutdown. Ownership does NOT
  transfer on sampling, so nothing on the learner's path may write a
  sampled trajectory in place.

The stream surface (``get``/``producer_done``/``close``/``CLOSED``) is kept
so ``ActorThread`` and the ``PipelinedRL`` learner loop drive this plane
unchanged. ``get()`` is **ticket-paced sampling**: it blocks until the ring
holds at least one *unconsumed* ticket (one fresh put a learner update —
the same 1:1 pacing as the FIFO planes, which keeps actor quotas, lockstep
and the bitwise pins meaningful), consumes it, then samples
``batch_size`` resident slots and concatenates them along the env axis
into one synthetic ``Rollout`` (``actor_id=-2``, ``seq`` = consume index,
``behavior_version`` = the *minimum* over the sampled slots — staleness
reports the oldest experience in the batch).

Sampling randomness: the draw of consume index ``i`` comes from a CPU
``torch.Generator`` seeded from ``np.random.SeedSequence([sample_seed,
i])`` (as ``repro_torch.utils.sampling.seeded_generators`` seeds its
streams), so a run's sample sequence is a pure function of ``(sample_seed,
consume order)`` — what lets ``SyncReplayDQN`` reproduce a lockstep
pipelined run bit for bit. Uniform draws are ``torch.randint``;
prioritized draws are ``torch.multinomial`` with replacement over the
priorities. The indices land on the host, where the ring's slot table
lives. ``idx`` on ``get`` replaces the draw (positions
among the resident slots, oldest first): a test seam that replays another
run's draws. New slots enter at the current maximum priority (everything
is sampled at least once — Schaul et al. 2016); ``update_priorities``
feeds TD errors back for the tickets ``last_sampled`` reports.

On the card, a part of a concatenated batch was written on its actor's
stream: ``get`` makes the consumer's stream wait for it and
``record_stream``s it there (``adopt``) before the concatenation. The
condition is the lock-order sanitizer's site ``replay_ring.cond``, and the
draw is the sanitizer's named edge ``"replay sample draw"``
(``repro_torch.analysis``).
"""
from __future__ import annotations

import queue as _queue
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.analysis.lockcheck import make_condition
from repro_torch.core.rollout import Transition
from repro_torch.pipeline.queue import CLOSED, QueueClosed
from repro_torch.pipeline.ring import _assert_on_device, adopt
from repro_torch.telemetry.spans import (QUEUE_GET_WAIT, REPLAY_ADD,
                                         REPLAY_EVICT, REPLAY_SAMPLE,
                                         SpanEmitter)

__all__ = ["ReplayRing", "sample_generator"]

TRACK = "replay"  # the ring's span track


def sample_generator(sample_seed: int, index: int) -> torch.Generator:
    """The CPU generator of draw ``index`` of the stream ``sample_seed``."""
    ss = np.random.SeedSequence([int(sample_seed), int(index)])
    g = torch.Generator()
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    return g


class _ReplaySlot:
    """One resident rollout: payload reference, ticket tag, priority."""

    __slots__ = ("payload", "ticket", "full", "priority")

    def __init__(self):
        self.payload: Any = None
        self.ticket: int = -1
        self.full: bool = False
        self.priority: float = 1.0


class ReplayRing:
    """Bounded multi-producer ring of on-device rollout slots, sampled with
    retention instead of consumed FIFO.

    Same stream surface as ``DeviceTrajectoryRing`` (``put`` / ``get`` /
    ``producer_done`` / ``close`` / ``CLOSED`` / idle accounting), but
    ``put`` never blocks (a full ring evicts the oldest ticket) and ``get``
    samples ``batch_size`` resident slots a consumed ticket. See the module
    docstring for the full contract.
    """

    def __init__(self, capacity: int = 64, batch_size: int = 1,
                 producers: int = 1, prioritized: bool = False,
                 sample_seed: int = 0, telemetry=None, device="cuda"):
        if capacity < 1:
            raise ValueError(f"replay capacity must be >= 1, got {capacity}")
        if batch_size < 1:
            raise ValueError(
                f"replay batch_size must be >= 1, got {batch_size}")
        if producers < 1:
            raise ValueError(f"producers must be >= 1, got {producers}")
        self.capacity = capacity
        self.batch_size = batch_size
        self.prioritized = prioritized
        self.sample_seed = sample_seed
        self.device = torch.device(device)
        self._slots: List[_ReplaySlot] = [
            _ReplaySlot() for _ in range(capacity)]
        self._tail = 0  # next ticket to issue (total accepted puts)
        self._evict_head = 0  # oldest resident ticket (evictions advance it)
        self._consumed = 0  # tickets consumed by get() (pacing counter)
        self._cond = make_condition("replay_ring.cond")
        self._producers_left = producers
        self._closed = False
        # tickets drawn by the most recent get()/sample(): the learner's
        # handle for update_priorities (single consumer, plain attribute)
        self.last_sampled: Tuple[int, ...] = ()
        self.evictions = 0  # total slots retired by full-ring puts
        if telemetry is not None:
            self.span_emitter = telemetry.emitter(TRACK, locked=True)
        else:
            self.span_emitter = SpanEmitter(TRACK, locked=True)

    # -- accounting (same surface as the FIFO planes) ------------------------
    @property
    def put_wait_s(self) -> float:
        """Always 0.0 — replay puts never block — kept for plane parity."""
        return 0.0

    @property
    def get_wait_s(self) -> float:
        """Learner idle (no fresh ticket) — span-derived."""
        return self.span_emitter.total(QUEUE_GET_WAIT)

    @property
    def tickets_issued(self) -> int:
        """Total puts accepted over the ring's lifetime (monotone)."""
        with self._cond:
            return self._tail

    def qsize(self) -> int:
        """Fresh (unconsumed) tickets — the pacing depth, not residency."""
        with self._cond:
            return self._tail - self._consumed

    @property
    def resident(self) -> int:
        """Rollouts currently held (sampleable): ``min(puts, capacity)``."""
        with self._cond:
            return self._tail - self._evict_head

    def resident_tickets(self) -> List[int]:
        """Tickets of the resident slots, oldest first."""
        with self._cond:
            return list(range(self._evict_head, self._tail))

    # -- producer side -------------------------------------------------------
    # hot-path
    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        """Deposit a rollout on the ring's device; never blocks.

        A full ring evicts its oldest resident slot (FIFO by ticket,
        ``replay.evict`` span) before inserting. Raises ``QueueClosed`` on a
        closed ring and ``TypeError`` for a payload off the ring's device.
        ``timeout`` is accepted for queue-surface parity but never needed.
        """
        del timeout  # surface parity: a replay put cannot block
        _assert_on_device(item, self.device, "ReplayRing")
        t0 = time.perf_counter()
        try:
            with self._cond:
                if self._closed:
                    raise QueueClosed("put() on a closed ReplayRing")
                if self._tail - self._evict_head >= self.capacity:
                    te = time.perf_counter()
                    slot = self._slots[self._evict_head % self.capacity]
                    # drop the ring's reference: the evicted rollout's
                    # memory returns to the allocator once no learner batch
                    # in flight still reads it
                    slot.payload = None
                    slot.ticket = -1
                    slot.full = False
                    self._evict_head += 1
                    self.evictions += 1
                    self.span_emitter.record(REPLAY_EVICT, te)
                ticket = self._tail
                self._tail = ticket + 1
                slot = self._slots[ticket % self.capacity]
                assert not slot.full, "replay invariant: slot must be free"
                slot.payload = item
                slot.ticket = ticket
                slot.full = True
                # fresh experience enters at the current max priority so it
                # is sampled at least once before TD errors rerank it
                slot.priority = max(
                    (s.priority for s in self._slots if s.full), default=1.0)
                self._cond.notify_all()
        finally:
            self.span_emitter.record(REPLAY_ADD, t0)

    # -- sampling ------------------------------------------------------------
    def _draw(self, generator: Optional[torch.Generator], batch_size: int,
              idx=None) -> List[_ReplaySlot]:
        """Pick ``batch_size`` resident slots (with replacement), or the
        resident positions ``idx``. Caller holds the lock; at least one
        slot is resident."""
        residents = [self._slots[t % self.capacity]
                     for t in range(self._evict_head, self._tail)]
        n = len(residents)
        # the intended host edge of a sampled get: the indices are drawn and
        # land on the host, where the slot table lives (and the sample
        # path's one named edge: get and sample both draw here)
        with sanitize.allowed("replay sample draw"):
            if idx is not None:
                idx = [int(i) for i in idx]
                if any(not 0 <= i < n for i in idx):
                    raise IndexError(f"replay draw {idx} outside the {n} "
                                     "resident slots")
            elif self.prioritized:
                prios = torch.tensor([s.priority for s in residents],
                                     dtype=torch.float64)
                if float(prios.sum()) <= 0.0:  # all-zero: uniform
                    prios = torch.ones(n, dtype=torch.float64)
                idx = torch.multinomial(prios, batch_size, replacement=True,
                                        generator=generator).tolist()
            else:
                idx = torch.randint(0, n, (batch_size,),
                                    generator=generator).tolist()
        return [residents[i] for i in idx]

    def sample(self, generator: torch.Generator,
               batch_size: Optional[int] = None) -> List[Any]:
        """Draw ``batch_size`` resident rollouts (retained, not consumed)
        from the caller's ``generator``.

        The reference's direct sampling surface, kept as the seam the
        ring's tests draw through: a draw that consumes no ticket, so the
        draw distribution is tested apart from the pacing. The learner
        path goes through ``get``. Raises ``queue.Empty`` on an empty ring
        and records the ``replay.sample`` span. Returns the payloads in
        draw order; ``last_sampled`` is set to their tickets.
        """
        if batch_size is None:
            batch_size = self.batch_size
        t0 = time.perf_counter()
        try:
            with self._cond:
                if self._tail == self._evict_head:
                    raise _queue.Empty
                slots = self._draw(generator, batch_size)
                self.last_sampled = tuple(s.ticket for s in slots)
                return [s.payload for s in slots]
        finally:
            self.span_emitter.record(REPLAY_SAMPLE, t0)

    def update_priorities(self, tickets: Sequence[int],
                          priorities: Sequence[float]) -> None:
        """Feed TD-error priorities back for previously sampled tickets.

        Tickets evicted since the sample are skipped (the experience is
        gone). Priorities are clamped to a small positive floor so no
        resident slot starves forever.
        """
        with self._cond:
            for t, p in zip(tickets, priorities):
                if self._evict_head <= t < self._tail:
                    slot = self._slots[t % self.capacity]
                    if slot.ticket == t:
                        slot.priority = max(float(p), 1e-6)

    # -- consumer (stream) side ---------------------------------------------
    def get(self, timeout: Optional[float] = None, idx=None) -> Any:
        """One sampled batch a fresh ticket: the learner-loop surface.

        Blocks until an unconsumed ticket exists (accumulating learner idle
        time), consumes it, samples ``batch_size`` resident slots with the
        draw of its consume index (or the positions ``idx``), and returns
        them concatenated along the env axis as one synthetic ``Rollout``.
        Returns ``CLOSED`` once the ring is closed (or every producer
        checked out) and every ticket is consumed; raises stdlib
        ``queue.Empty`` on timeout.
        """
        from repro_torch.pipeline.actor import Rollout

        t0 = time.perf_counter()
        try:
            with self._cond:
                if not self._cond.wait_for(
                        lambda: self._closed or self._consumed < self._tail,
                        timeout=timeout):
                    raise _queue.Empty
                if self._consumed >= self._tail:
                    return CLOSED  # closed and ticket-drained
                seq = self._consumed
                self._consumed = seq + 1
                ts = time.perf_counter()
                slots = self._draw(
                    None if idx is not None
                    else sample_generator(self.sample_seed, seq),
                    self.batch_size, idx)
                self.last_sampled = tuple(s.ticket for s in slots)
                parts = [s.payload for s in slots]
                version = min(p.behavior_version for p in parts)
                self._cond.notify_all()
        finally:
            self.span_emitter.record(QUEUE_GET_WAIT, t0)
        # assembly outside the lock: producers must not stall behind a
        # device concatenation. Single consumer, so the references taken
        # above cannot race another get (eviction only drops the ring's
        # reference — `parts` keeps the payloads alive for this batch).
        try:
            if len(parts) == 1:
                p = parts[0]
                return Rollout(p.traj, p.last_obs, version, actor_id=-2,
                               seq=seq, release=None, ready=p.ready)
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                for p in parts:  # written on the actors' streams
                    adopt(p, stream)
            traj = Transition(*(torch.cat(fs, dim=1)
                                for fs in zip(*[p.traj for p in parts])))
            last_obs = torch.cat([p.last_obs for p in parts], dim=0)
            # replay-sampled: no single producing replica
            return Rollout(traj, last_obs, version, actor_id=-2, seq=seq,
                           release=None)
        finally:
            self.span_emitter.record(REPLAY_SAMPLE, ts)

    # -- shutdown (same protocol as the FIFO planes) -------------------------
    def producer_done(self) -> None:
        """One producer finished its quota; the stream closes when the last
        producer checks out (the consumer drains the remaining tickets,
        then sees ``CLOSED``)."""
        with self._cond:
            self._producers_left -= 1
            if self._producers_left <= 0:
                self._closed = True
            self._cond.notify_all()

    def close(self) -> None:
        """Hard abort: wakes producers (``QueueClosed``) and the consumer
        (``CLOSED`` after the remaining tickets drain). Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

"""Continuous-batching scheduler: admission queue -> slot-managed decode.

Two modes over one loop and one engine:

* **continuous** (the service): a request is admitted the moment a cache
  slot frees up, joining the decode batch mid-flight; it leaves the
  moment it finishes. The batch is never drained to admit.
* **lockstep** (the generate-then-drain baseline, and the solo reference
  for the bitwise pin): admission only happens when the batch is empty —
  a wave fills up, decodes until its *longest* request completes, then
  drains. Finished rows idle until the wave ends; that idle is exactly
  what the serve bench measures continuous batching against.

Both modes pull from a ``TrajectoryQueue`` (the host queue plane's
close/backpressure contract): the traffic source
``put``s ``Request``s and calls ``producer_done()``; the scheduler
``get``s until ``CLOSED`` and then drains its active batch. Backpressure
toward the traffic source is the queue's own bounded-depth blocking.

Slot discipline: ``KVSlotCache.allocate`` at admission, with the free
deferred into the request's ``_free`` closure (the ring's
``Rollout.release`` handoff idiom); the closure runs exactly once, at retire. Eviction
(cache-window overflow) reclaims the slot via ``evict`` and errors the
request.

Telemetry: the scheduler's emitter uses the serving category table
``("admit", "prefill", "decode", "evict")``; the reference's hub gauges
and trace export wait for the port's telemetry slice. The decode step is ``# hot-path``: no host syncs between
steps (completion is length-based; tokens materialize only at retire).
"""
from __future__ import annotations

import queue as _queue
import time
from typing import Dict, List

import numpy as np

from repro_torch.pipeline.queue import CLOSED
from repro_torch.serving.request import ACTIVE, DONE, ERRORED, Request
from repro_torch.serving.slots import KVSlotCache
from repro_torch.telemetry.spans import SpanEmitter
from repro_torch.utils import get_logger

log = get_logger("serving")

SERVE_CATEGORIES = ("admit", "prefill", "decode", "evict")
_ADMIT, _PREFILL, _DECODE, _EVICT = 0, 1, 2, 3


class Scheduler:
    """Drive one engine from one admission queue until both drain."""

    def __init__(self, engine, queue, *, continuous: bool = True,
                 name: str = "serve"):
        self.engine = engine
        self.queue = queue
        self.continuous = continuous
        self.slots = KVSlotCache(engine.max_slots)
        self.em = SpanEmitter(name, categories=SERVE_CATEGORIES)
        self._active: Dict[int, Request] = {}  # slot -> request
        self.completed: List[Request] = []
        self.admit_order: List[int] = []  # rids, FIFO-fairness pin
        self.steps = 0  # decode steps dispatched (bench: batch occupancy)
        self._drained = False  # queue delivered CLOSED

    # -- lifecycle -----------------------------------------------------------
    def run(self) -> List[Request]:
        """Serve until the admission queue closes+drains and every active
        request retires. Returns every request, completed or errored."""
        while True:
            self._admit()
            self._retire()  # budgets met by the prefill token alone
            if not self._active:
                if self._drained:
                    break
                continue  # _admit blocks for the next request
            self._step()
            self._retire()
        self.slots.close()
        return self.completed

    # -- admission -----------------------------------------------------------
    def _admit(self) -> None:
        if not self.continuous and self._active:
            return  # lockstep: next wave only after a full drain
        while not self._drained and self.slots.free_count > 0:
            block = not self._active  # idle batch: wait for work
            try:
                item = self.queue.get(timeout=None if block else 0.0)
            except _queue.Empty:
                return
            if item is CLOSED:
                self._drained = True
                return
            self._admit_one(item)

    def _admit_one(self, req: Request) -> None:
        self.em.begin(_ADMIT)
        try:
            req.t_admit = time.perf_counter()
            if req.prompt.shape[0] + req.max_new_tokens > self.engine.max_len:
                self._error(req, (
                    f"prompt {req.prompt.shape[0]} + max_new_tokens "
                    f"{req.max_new_tokens} exceeds the engine's "
                    f"max_len={self.engine.max_len}"))
                return
            rid = req.rid
            slot = self.slots.allocate(rid)
            # deferred handoff: the slot frees exactly once, at retire
            req._free = (lambda s=slot, r=rid: self.slots.free(s, r))
            req.slot = slot
            self.em.begin(_PREFILL)
            try:
                self.engine.admit(slot, req.prompt, req.seed)
            except Exception as e:  # prefill failed: lease back, error out
                self.em.cancel()
                req._free()
                req._free = None
                req.slot = None
                self._error(req, f"{type(e).__name__}: {e}")
                return
            self.em.end()
            req.status = ACTIVE
            req.t_first = time.perf_counter()
            req.n_live = 1  # the prefill-sampled token (stream index 0)
            self._active[slot] = req
            self.admit_order.append(rid)
        finally:
            self.em.end()

    def _error(self, req: Request, msg: str,
               tokens: np.ndarray = None) -> None:
        req.status = ERRORED
        req.error = msg
        req.tokens = tokens if tokens is not None else np.zeros(0, np.int32)
        req.t_done = time.perf_counter()
        self.completed.append(req)
        log.warning("request %d errored: %s", req.rid, msg)

    # -- decode --------------------------------------------------------------
    # hot-path
    def _step(self) -> None:
        """One fixed-width decode step. The host side only counts: tokens
        stay in the engine's device ring log until harvest at retire, so
        the loop issues exactly one dispatch per step — no per-row
        gathers, no syncs (completion is length-based)."""
        self.em.begin(_DECODE)
        try:
            self.engine.step()
            for slot, req in self._active.items():
                self.slots.assert_owner(slot, req.rid)
                req.n_live += 1
            self.steps += 1
        finally:
            self.em.end()

    # -- retire / evict ------------------------------------------------------
    def _retire(self) -> None:
        for slot in list(self._active):
            req = self._active[slot]
            if req.n_generated >= req.max_new_tokens:
                del self._active[slot]
                req.tokens = self.engine.harvest(slot, req.n_live)
                req.status = DONE
                req.t_done = time.perf_counter()
                req._free()  # the deferred lease handoff, exactly once
                req._free = None
                self.engine.release(slot)
                self.completed.append(req)
            elif self.engine.remaining(slot) <= 0:
                self._evict(slot, req,
                            f"cache row overflow: pos reached max_len="
                            f"{self.engine.max_len} before "
                            f"{req.max_new_tokens} tokens generated")

    def _evict(self, slot: int, req: Request, msg: str) -> None:
        self.em.begin(_EVICT)
        try:
            del self._active[slot]
            evicted = self.slots.evict(slot)
            assert evicted == req.rid, (evicted, req.rid)
            req._free = None  # lease reclaimed by evict, not the closure
            partial = self.engine.harvest(slot, req.n_live)
            self.engine.release(slot)
            self._error(req, msg, tokens=partial)
        finally:
            self.em.end()

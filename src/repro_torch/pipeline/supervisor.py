"""Actor supervision: respawn, degrade, or fail — but never hang (a port of
``repro.pipeline.supervisor``).

The pre-supervisor pipeline is deliberately fail-fast: a dying replica
hard-``close()``s the trajectory stream so the learner and its siblings
unwind promptly (``ActorBase.run``'s epilogue). That is the right default
for bitwise reproducibility work, but a long training run on flaky envs
wants the GA3C/IMPALA operational posture instead: a crashed actor is an
*event*, not a verdict. ``PipelineConfig.elastic=True`` arms this module.

Two pieces:

* ``QuotaLedger`` — the run's work-conservation account. ``outstanding``
  is total quota not yet produced anywhere; a dead replica's unproduced
  remainder is ``orphan``ed into an unassigned pool that surviving
  replicas ``wait_for_work`` on *instead of checking out* when their own
  quota is done. The ledger is what closes the respawn-vs-``producer_done``
  race: a survivor cannot check out while a dead sibling's quota is still
  outstanding, so the stream never loses its last producer to a timing
  window.

* ``ActorSupervisor`` — the recovery policy, run *on the dying replica's
  own thread* (``ActorBase.run`` consults it before hard-closing, so the
  thread is still alive — and still counted by the learner's liveness
  checks — for the whole recovery episode). Per slot, under
  ``restart_budget``: sleep the exponential backoff, respawn a replacement
  with a fresh ``(actor_id, seq)`` epoch (it re-leases current params on
  its first acquire, and inherits the dead replica's producer slot — no
  queue accounting changes hands). Past the budget: orphan the remainder
  to the ledger, check the slot out, and let the run degrade to fewer
  actors. Only when *no* live replica remains to absorb the work does the
  supervisor declare the fault fatal and fall back to the fail-fast
  close. Every episode is a ``fault.detect`` / ``fault.respawn`` /
  ``fault.giveup`` span on the supervisor's trace track plus a heartbeat
  counter.

The mesh plane never gets a supervisor: one dead lane leaves every
subsequent globally-sharded batch unassemblable, so respawn-into-a-fresh-
epoch cannot preserve its semantics. ``PipelineConfig`` rejects the
combination; the mesh plane stays fail-fast (see docs/fault_tolerance.md).

The ledger's condition and the supervisor's lock are the lock-order
sanitizer's sites ``quota_ledger.cond`` and ``supervisor.lock``
(``repro_torch.analysis.lockcheck``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from repro_torch.analysis.lockcheck import make_condition, make_lock
from repro_torch.pipeline.faults import InjectedActorFault
from repro_torch.telemetry.spans import (FAULT_DETECT, FAULT_GIVEUP,
                                         FAULT_RESPAWN)
from repro_torch.utils import get_logger

__all__ = ["QuotaLedger", "ActorSupervisor"]

log = get_logger("pipeline")


class QuotaLedger:
    """Work-conservation account for one elastic ``run()``.

    ``outstanding`` = payloads the run still owes the learner, wherever
    they come from; ``unassigned`` = orphaned quota awaiting a claimant.
    Replicas call ``produced()`` per successful put; the supervisor calls
    ``orphan(n)`` when it degrades a slot; survivors block in
    ``wait_for_work`` at the end of their own quota until either orphaned
    work appears (claim it, keep producing) or no work can remain (check
    out). ``abort()`` releases every waiter (fatal fault / learner stop).
    """

    def __init__(self, total: int):
        self._cond = make_condition("quota_ledger.cond")
        self._outstanding = int(total)
        self._unassigned = 0
        self._aborted = False

    def produced(self) -> None:
        with self._cond:
            self._outstanding -= 1
            self._cond.notify_all()

    def orphan(self, n: int) -> None:
        """Credit a dead replica's unproduced remainder to the pool."""
        if n <= 0:
            return
        with self._cond:
            self._unassigned += int(n)
            self._cond.notify_all()

    def claim(self) -> int:
        """Take the whole unassigned pool (respawn / continuation path)."""
        with self._cond:
            n = self._unassigned
            self._unassigned = 0
            return n

    def wait_for_work(self, stop: Optional[Callable[[], bool]] = None,
                      tick: float = 0.1) -> int:
        """Block until orphaned quota exists (claim and return 1) or no
        work can remain — outstanding drained, aborted, or ``stop()`` —
        (return 0). Claiming one unit at a time spreads a degrade across
        every surviving replica instead of dogpiling the first waiter."""
        with self._cond:
            while True:
                if self._aborted or self._outstanding <= 0:
                    return 0
                if self._unassigned > 0:
                    self._unassigned -= 1
                    return 1
                if stop is not None and stop():
                    return 0
                self._cond.wait(tick)

    def abort(self) -> None:
        with self._cond:
            self._aborted = True
            self._cond.notify_all()

    @property
    def outstanding(self) -> int:
        with self._cond:
            return self._outstanding


def _live(actor) -> bool:
    """A registered replica counts as live until it has run and ended.
    ``PipelinedRL.run`` registers every replica, then starts them one after
    another (thread and process backends alike), so a sibling that has not
    started yet is still to come and can absorb an orphaned quota; a
    respawned replica is started before it is registered."""
    return actor.ident is None or actor.is_alive()


class ActorSupervisor:
    """Recovery policy for dying actor replicas (see module docstring).

    ``respawner(dead, new_actor_id, remaining)`` is the backend-specific
    factory the orchestrator provides: build **and start** a replacement
    replica covering ``remaining`` payloads under the fresh epoch id, or
    return ``None`` to decline (the episode then degrades). The supervisor
    owns the dynamic replica list — the orchestrator's join/stop/error
    sweeps run over ``all_actors()``.
    """

    def __init__(self, queue, ledger: QuotaLedger,
                 respawner: Callable, restart_budget: int = 1,
                 backoff_s: float = 0.05, telemetry=None):
        self._queue = queue
        self._ledger = ledger
        self._respawner = respawner
        self._budget = int(restart_budget)
        self._backoff = float(backoff_s)
        self._telemetry = telemetry
        # locked: episodes can fire from several dying threads at once
        self._em = (telemetry.emitter("supervisor", locked=True)
                    if telemetry is not None else None)
        self._lock = make_lock("supervisor.lock")
        self._actors: List = []
        self._attempts: Dict[int, int] = {}  # slot -> respawns so far
        self._next_id = 0
        self._shutdown = False
        self.fatal = None  # the replica whose death ended the run, if any
        # audit trail of (kind, slot, actor_id) episodes for tests/logs
        self.episodes: List[tuple] = []

    # -- replica registry -----------------------------------------------------
    def register(self, actor) -> None:
        with self._lock:
            self._actors.append(actor)
            self._next_id = max(self._next_id, actor.actor_id + 1)
        actor.supervisor = self

    def all_actors(self) -> List:
        with self._lock:
            return list(self._actors)

    def slot_actor(self, slot: int):
        """The newest replica occupying ``slot`` (epochs shadow earlier)."""
        with self._lock:
            for a in reversed(self._actors):
                if a.slot_index == slot:
                    return a
        return None

    def shutdown(self) -> None:
        """Disarm recovery (run teardown): deaths stop respawning."""
        with self._lock:
            self._shutdown = True

    def _count(self, name: str) -> None:
        if self._telemetry is not None:
            self._telemetry.counter_add(name, 1)

    def _span(self, cat: int, t0: float) -> None:
        if self._em is not None:
            self._em.record(cat, t0)

    # -- the recovery episode (runs on the dying replica's thread) -----------
    def on_actor_error(self, actor) -> bool:
        """Handle ``actor``'s death. True = recovered (respawned replica
        inherits the producer slot, or the slot was checked out after
        orphaning its quota); False = fatal, caller falls back to the
        fail-fast ``queue.close()``."""
        t0 = time.perf_counter()
        kind = ("injected" if isinstance(actor.error, InjectedActorFault)
                or "FaultPlan" in str(actor.error) else "crash")
        remaining = max(int(actor.assigned) - int(actor.produced), 0)
        self._count("fault.detect")
        self._span(FAULT_DETECT, t0)
        log.warning(
            "supervisor: actor %d (slot %d) died after %d/%d rollouts "
            "(%s): %s", actor.actor_id, actor.slot_index, actor.produced,
            actor.assigned, kind, actor.error)
        with self._lock:
            if self._shutdown:
                return False
            attempts = self._attempts.get(actor.slot_index, 0)
            can_respawn = attempts < self._budget
            if can_respawn:
                self._attempts[actor.slot_index] = attempts + 1
                new_id = self._next_id
                self._next_id += 1
        if can_respawn:
            # exponential backoff on the dying thread: the replica stays
            # alive (and visibly so, for the learner's liveness checks)
            # for the whole recovery episode
            time.sleep(self._backoff * (2 ** attempts))
            with self._lock:
                disarmed = self._shutdown
            replacement = None
            if not disarmed:
                t1 = time.perf_counter()
                try:
                    replacement = self._respawner(actor, new_id, remaining)
                except Exception:
                    log.exception(
                        "supervisor: respawn of slot %d failed — degrading",
                        actor.slot_index)
                if replacement is not None:
                    with self._lock:
                        self._actors.append(replacement)
                    replacement.supervisor = self
                    self._count("fault.respawn")
                    self._span(FAULT_RESPAWN, t1)
                    self.episodes.append(
                        ("respawn", actor.slot_index, new_id))
                    log.warning(
                        "supervisor: respawned slot %d as actor %d "
                        "(attempt %d/%d, %d rollouts remaining)",
                        actor.slot_index, new_id, attempts + 1,
                        self._budget, remaining)
                    # the replacement inherits this replica's producer
                    # slot: neither close nor producer_done here
                    return True
        # give up on the slot: degrade if any sibling can absorb the work
        t2 = time.perf_counter()
        self._count("fault.giveup")
        self._span(FAULT_GIVEUP, t2)
        self.episodes.append(("giveup", actor.slot_index, actor.actor_id))
        others = [a for a in self.all_actors()
                  if a is not actor and _live(a)]
        if others or remaining == 0:
            self._ledger.orphan(remaining)
            self._queue.producer_done()  # check the dead slot out
            log.warning(
                "supervisor: gave up on slot %d — %d rollouts reassigned, "
                "run degrades to %d live actor(s)",
                actor.slot_index, remaining, len(others))
            return True
        self.fatal = actor
        self._ledger.abort()
        log.error(
            "supervisor: actor %d was the last live replica — aborting run",
            actor.actor_id)
        return False

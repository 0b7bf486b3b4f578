"""Deterministic fault injection for the pipeline's recovery paths (a port
of ``repro.pipeline.faults``, which is plain Python: the same plan, the
same injector, the same texts).

Fault tolerance that is only exercised by real crashes is fault tolerance
that rots: the respawn/degrade/resume machinery in
``repro_torch.pipeline.supervisor`` and the checkpoint plane must be drivable
from a test, bit-reproducibly, on every CI run. ``FaultPlan`` is what
drives them — a frozen description of *exactly which* fault fires
*exactly when*, carried on ``PipelineConfig.fault_plan`` and armed once per
``PipelinedRL.run()``:

* ``kills`` — kill actor slot *k* after it has produced *n* rollouts.
  Mode ``"error"`` raises ``InjectedActorFault`` inside the replica (the
  env-crash shape: thread actors die on their own thread; process workers
  report a traceback and survive for reuse). Mode ``"exit"`` hard-exits
  the worker process (``os._exit`` — the segfault/OOM-kill shape the
  drainer's liveness poll detects as silent death); on the thread backend,
  where a thread cannot be killed from outside, it degrades to ``"error"``.
* ``lease_delays`` — sleep before slot *k*'s param acquire on rollout
  *n*: widens the lease window so reserve/timeout races become schedulable.
* ``drop_release`` — skip the learner's ``payload.release()`` once at
  iteration *n*: proves the ``queue_depth + 2`` staging-ring sizing
  absorbs one leaked lease instead of deadlocking the producer.
* ``stall_learner`` — sleep *s* seconds in the learner loop before update
  *n*: the slow-learner regime (backpressure, watchdog, crash-during-
  blocked-put scheduling).

Every entry is **one-shot**: the runtime ``FaultInjector`` marks it fired,
so a respawned replica re-collecting the same rollout index does not die
again — which is precisely what lets a test assert "kill once, recover,
finish the full quota". The plan object itself stays immutable/hashable
(it rides a frozen config).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Tuple

__all__ = ["FaultPlan", "FaultInjector", "InjectedActorFault"]

_KILL_MODES = ("error", "exit")


class InjectedActorFault(RuntimeError):
    """The planned failure a ``FaultPlan.kills`` entry raises inside an
    actor replica. Distinct type so the supervisor (and tests) can tell a
    scheduled fault from a genuine env/plumbing crash."""


@dataclass(frozen=True)
class FaultPlan:
    """Immutable schedule of pipeline faults (see module docstring).

    Field formats (all tuples — the plan rides a frozen, hashable config):

    * ``kills``: ``(slot, after_rollouts, mode)`` — kill the replica on
      slot ``slot`` when its produced-rollout count reaches
      ``after_rollouts`` (0 = before its first rollout); ``mode`` is
      ``"error"`` (raise in-replica) or ``"exit"`` (hard process exit).
    * ``lease_delays``: ``(slot, rollout, seconds)`` — sleep before the
      slot's param acquire on local rollout index ``rollout``.
    * ``drop_release``: learner iteration indices whose payload release
      is skipped (once each).
    * ``stall_learner``: ``(iteration, seconds)`` — sleep in the learner
      loop before that update dispatches.
    """

    kills: Tuple[Tuple[int, int, str], ...] = ()
    lease_delays: Tuple[Tuple[int, int, float], ...] = ()
    drop_release: Tuple[int, ...] = ()
    stall_learner: Tuple[Tuple[int, float], ...] = ()

    def __post_init__(self):
        for slot, after, mode in self.kills:
            if slot < 0 or after < 0:
                raise ValueError(
                    f"FaultPlan.kills entry ({slot}, {after}, {mode!r}): "
                    "slot and after_rollouts must be >= 0")
            if mode not in _KILL_MODES:
                raise ValueError(
                    f"FaultPlan.kills mode must be one of {_KILL_MODES}, "
                    f"got {mode!r}")
        for slot, rollout, seconds in self.lease_delays:
            if slot < 0 or rollout < 0 or seconds < 0:
                raise ValueError(
                    f"FaultPlan.lease_delays entry ({slot}, {rollout}, "
                    f"{seconds}): all fields must be >= 0")
        for it in self.drop_release:
            if it < 0:
                raise ValueError(
                    f"FaultPlan.drop_release iteration must be >= 0, got {it}")
        for it, seconds in self.stall_learner:
            if it < 0 or seconds < 0:
                raise ValueError(
                    f"FaultPlan.stall_learner entry ({it}, {seconds}): "
                    "iteration and seconds must be >= 0")


class FaultInjector:
    """Per-run arming of a ``FaultPlan``: fires each entry exactly once.

    Thread-safe — entries are consulted from actor threads, drainer
    threads and the learner loop concurrently. A fired entry never fires
    again within the run, so a respawned replica replaying the fatal
    rollout index sails through (the recovery test contract).
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._fired: set = set()
        self._lock = threading.Lock()

    def _claim(self, token) -> bool:
        with self._lock:
            if token in self._fired:
                return False
            self._fired.add(token)
            return True

    # -- actor-side hooks ----------------------------------------------------
    def maybe_kill(self, slot: int, produced: int) -> None:
        """Raise the planned fault for ``slot`` once its produced count
        matches. Thread backend only — ``"exit"`` degrades to ``"error"``
        here (a thread cannot be hard-killed from outside the interpreter;
        the process backend gets true hard exits via ``kills_for_worker``).
        """
        for i, (s, after, mode) in enumerate(self.plan.kills):
            if s == slot and after == produced and self._claim(("kill", i)):
                raise InjectedActorFault(
                    f"FaultPlan: killed actor slot {slot} after "
                    f"{produced} rollouts (mode={mode!r})"
                )

    def kills_for_worker(self, slot: int) -> Tuple[Tuple[int, str], ...]:
        """Claim and return ``(after_rollouts, mode)`` entries to ship in a
        worker's run command — the child executes them in its own process
        (including true ``os._exit`` hard kills). Claimed here so a
        respawned worker's fresh run command carries no faults."""
        out = []
        for i, (s, after, mode) in enumerate(self.plan.kills):
            if s == slot and self._claim(("kill", i)):
                out.append((after, mode))
        return tuple(out)

    def lease_delay(self, slot: int, rollout: int) -> None:
        for i, (s, r, seconds) in enumerate(self.plan.lease_delays):
            if s == slot and r == rollout and self._claim(("delay", i)):
                time.sleep(seconds)

    # -- learner-side hooks --------------------------------------------------
    def drop_release(self, iteration: int) -> bool:
        """True exactly once per planned iteration: the learner skips this
        payload's ``release()`` (a deliberately leaked staging lease)."""
        for i, it in enumerate(self.plan.drop_release):
            if it == iteration and self._claim(("drop", i)):
                return True
        return False

    def stall_learner(self, iteration: int) -> None:
        for i, (it, seconds) in enumerate(self.plan.stall_learner):
            if it == iteration and self._claim(("stall", i)):
                time.sleep(seconds)

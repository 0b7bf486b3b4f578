"""The process actor plane: worker subprocesses for GIL-bound envs (a port
of ``repro.pipeline.worker``).

The thread plane (``ActorThread``) scales exactly as far as the emulator
releases the GIL: a *Python-bound* emulator serializes every replica's
env stepping on one interpreter lock, so adding actors adds nothing.
``PipelineConfig.actor_backend = "process"`` puts each actor replica in
its own interpreter.

Topology (everything above the ``TrajectoryQueue`` — the learner loop,
the V-trace update, the metrics — is the thread plane's)::

    worker subprocess i                     parent process
    ───────────────────                     ──────────────
    spec.build() → private HostEnvPool      ProcessActorDrainer i (thread)
    own act step on spec.device             ready_q.get() → wrap shm views
    loop: lease params ← ShmParamView         → Rollout → TrajectoryQueue
          free_q.get() → ShmStagingSet        (ActorBase quota/shutdown/
          collect_host(staging=set)            never-drop protocol)
          ready_q.put(set index)            learner: get → update → publish
    params ← shm ping-pong slot  ◀──────────  (one D2H copy an update)

Wire protocol (a worker, all ``mp.Queue``):

* ``cmd_q``   parent→child: ``("run", quota, lockstep, kills)`` |
  ``("stop",)``; ``kills`` are the ``(after, mode)`` faults of a
  ``FaultPlan`` the child runs itself: ``"error"`` raises (the child
  reports it and stays at its command loop), ``"exit"`` is
  ``os._exit(17)`` (a silent death).
* ``ready_q`` child→parent: ``("rollout", set_idx, seq, version)`` …
  then ``("spans", SpanEmitter.ship())`` — the child's span ring (lease,
  shm.copy, staging wait and collect spans, recorded child-side), merged
  parent-side under the process track ``actor_id + 1`` — terminated by
  exactly one of ``("done", generator_state)`` (quota finished),
  ``("aborted",)`` (stop event honoured) or ``("error", traceback)``
  (collection died; the drainer re-raises it so the stream hard-closes
  exactly like a crashed ``ActorThread``).
* ``free_q``  both ways: staging-set indices — the cross-process
  ``HostStagingRing`` lease. The parent seeds ``queue_depth + 2`` indices,
  the child takes one before writing, the learner's ``Rollout.release``
  gives it back after consuming.

Nothing that crosses the boundary is a torch tensor: params travel
through the ``ShmParamSlot``, the acting generator as the bytes of its
state, everything else as numpy or plain Python. The child acts on the
device its ``HostEnvSpec`` names, with a CUDA context of its own on the
card; it builds and launches no kernel (only the learner runs K1/K2). A
spawned child inherits none of the parent's torch settings, so the plane
captures ``cudnn.deterministic``/``benchmark``, both ``allow_tf32`` flags
and ``torch.get_num_threads()`` and the child sets them before its first
forward.

Child lifecycle: workers are spawned (never forked: a CUDA context cannot
be forked) once a ``PipelinedRL`` and persist across ``run()`` calls; they
are daemonic *and* poll ``multiprocessing.parent_process().is_alive()`` in
every blocking loop, so neither a clean parent exit nor a hard kill leaves
orphans stepping envs. A worker that dies silently (segfault, OOM kill) is
detected by its drainer's liveness poll and surfaced as the actor error;
under a supervisor that error goes to ``on_actor_error`` instead of
closing the stream, and ``respawn_worker`` stands the slot back up: it
reuses the child while it lives (an ``"error"`` leaves it parked at its
command loop) and otherwise retires the handle to a graveyard and spawns a
fresh child with a fresh shm estate and a generator seeded from
``SeedSequence([seed, slot, epoch])``. Retired staging sets may still back
payloads in flight, so they are unlinked only at ``close``.

The publish's copy to shared memory is the transfer sanitizer's named
edge ``"shm param publish"`` (``repro_torch.analysis.sanitize``).
"""
from __future__ import annotations

import atexit
import multiprocessing as mp
import os
import queue as _stdlib_queue
import traceback
import weakref
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.envs.host_env import HostEnvSpec
from repro_torch.pipeline.actor import ActorBase, Rollout, _copy_tree
from repro_torch.pipeline.shm import ShmParamSlot, ShmStagingSet
from repro_torch.telemetry.spans import (COLLECT, LEASE, QUEUE_PUT_WAIT,
                                         SHM_COPY, SpanEmitter)
from repro_torch.utils.sampling import generator_state, set_generator_state

__all__ = ["ProcessActorPlane", "ProcessActorDrainer", "torch_settings"]


def torch_settings() -> dict:
    """The torch settings a spawned child does not inherit."""
    return {
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_tf32": torch.backends.cudnn.allow_tf32,
        "num_threads": torch.get_num_threads(),
    }


def _apply_torch_settings(s: dict) -> None:
    torch.backends.cudnn.deterministic = s["cudnn_deterministic"]
    torch.backends.cudnn.benchmark = s["cudnn_benchmark"]
    torch.backends.cuda.matmul.allow_tf32 = s["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = s["cudnn_tf32"]
    torch.set_num_threads(s["num_threads"])


def _parent_alive() -> bool:
    p = mp.parent_process()
    return p is not None and p.is_alive()


def _orphan_unlink(sets, slot) -> None:
    """Child-side last resort for the shm estate: the parent normally owns
    every unlink, but a parent killed hard (SIGKILL) never runs its atexit
    reaper — the orphaned child destroys the segments on its way out so
    /dev/shm does not leak. POSIX unlink is safe under live mappings, and a
    sibling orphan racing us sees FileNotFoundError, which is success."""
    for s in sets or ():
        try:
            s.shm.unlink()
        except Exception:
            pass
    if slot is not None:
        for shm in getattr(slot, "_shms", ()) or ():
            try:
                shm.unlink()
            except Exception:
                pass


def _worker_main(spec: HostEnvSpec, arch_cfg, hp, slot_handle,
                 set_names: Sequence[str], gen_state: bytes, settings: dict,
                 cmd_q, ready_q, free_q, stop_evt, actor_id: int) -> None:
    """Child entry point: rebuild the env pool and the acting step, then
    serve ``run`` commands until ``stop`` (or the parent disappears)."""
    from repro_torch.core.agents.paac import PAACAgent
    from repro_torch.pipeline.actor import collect_host, make_host_act_step
    from repro_torch.pipeline.shm import ShmParamView

    pool = None
    sets: List[ShmStagingSet] = []
    slot = None
    try:
        _apply_torch_settings(settings)
        agent = PAACAgent(arch_cfg, hp)
        act_step = make_host_act_step(agent.act_fn())
        t_max = hp.t_max
        pool = spec.build()
        sets = [ShmStagingSet(t_max, spec.n_envs, spec.obs_shape,
                              spec.obs_dtype, name=n, create=False)
                for n in set_names]
        # reader_id = this worker's slot: its param leases are attributable
        # (reserve-timeout diagnostics) and revocable
        slot = ShmParamView(slot_handle, reader_id=actor_id,
                            device=pool.device)
        gen = torch.Generator(device=pool.device)
        set_generator_state(gen, gen_state)
        obs = pool.reset()
        # this worker's span track: recorded here, shipped to the parent
        # with the terminal message of each run
        em = SpanEmitter(f"worker{actor_id}")
    except Exception:
        # setup died (unbuildable env, shm attach failure): report it so the
        # first run surfaces a traceback, not a bare dead child
        ready_q.put(("error", traceback.format_exc()))
        if pool is not None:
            pool.close()
        return
    try:
        while True:
            try:
                cmd = cmd_q.get(timeout=1.0)
            except _stdlib_queue.Empty:
                if not _parent_alive():
                    # orphaned: the parent died without "stop" — and
                    # without its unlink duty (a hard kill skips atexit)
                    _orphan_unlink(sets, slot)
                    return
                continue
            if cmd[0] == "stop":
                return
            # faults: the planned (after, mode) kills this run executes in
            # its own process
            _, quota, lockstep, faults = cmd
            try:
                aborted = False
                for seq in range(quota):
                    for after, mode in faults:
                        if after == seq:
                            if mode == "exit":
                                # the segfault/OOM-kill shape: no message,
                                # no traceback — the drainer's liveness
                                # poll must detect the silent death
                                os._exit(17)
                            raise RuntimeError(
                                f"FaultPlan: injected worker fault on actor "
                                f"{actor_id} after {seq} rollouts "
                                f"(mode={mode!r})")
                    if lockstep:
                        em.begin(LEASE)
                        while not slot.wait_for(seq, timeout=0.1):
                            if stop_evt.is_set() or not _parent_alive():
                                aborted = True
                                break
                        if aborted:  # an abort mid-wait is not waiting
                            em.cancel()
                        else:
                            em.end()
                    if aborted or stop_evt.is_set():
                        aborted = True
                        break
                    # the params lease is just the copy-out (inside
                    # read_params): the shm→device copy is the span
                    em.begin(SHM_COPY)
                    try:
                        params, version = slot.read_params()
                    finally:
                        em.end()
                    # the cross-process staging lease: blocked here = the
                    # parent has not recycled a set (backpressure)
                    em.begin(QUEUE_PUT_WAIT)
                    idx: Optional[int] = None
                    while idx is None:
                        try:
                            idx = free_q.get(timeout=0.1)
                        except _stdlib_queue.Empty:
                            if stop_evt.is_set() or not _parent_alive():
                                aborted = True
                                break
                    if aborted:
                        em.cancel()
                        break
                    em.end()
                    em.begin(COLLECT)
                    try:
                        obs, _traj, _last = collect_host(
                            act_step, pool, params, obs, gen, t_max,
                            staging=sets[idx])
                    except Exception:
                        free_q.put(idx)  # don't leak the staging lease
                        raise
                    finally:
                        em.end()
                    del params
                    ready_q.put(("rollout", idx, seq, version))
                ready_q.put(("spans", em.ship()))
                em.reset()  # a later run must not re-ship this run's spans
                if aborted:
                    ready_q.put(("aborted",))
                else:
                    ready_q.put(("done", generator_state(gen)))
            except Exception:
                # collection died (env crash, shm torn down, ...): report
                # and survive — the drainer turns this into the actor error
                tb = traceback.format_exc()
                try:
                    ready_q.put(("spans", em.ship()))
                    em.reset()
                except Exception:  # never mask the real failure
                    pass
                ready_q.put(("error", tb))
    finally:
        pool.close()
        for s in sets:
            s.close()
        slot.close()


class _WorkerHandle:
    """Parent-side bookkeeping for one spawned worker."""

    def __init__(self, actor_id: int, proc, cmd_q, ready_q, free_q, stop_evt,
                 sets: List[ShmStagingSet]):
        self.actor_id = actor_id
        self.proc = proc
        self.cmd_q = cmd_q
        self.ready_q = ready_q
        self.free_q = free_q
        self.stop_evt = stop_evt
        self.sets = sets  # parent-side views of the same shm blocks


class ProcessActorDrainer(ActorBase):
    """Parent-side thread standing in for one worker subprocess.

    To everything above the plane split this *is* the actor replica: it
    honours ``ActorBase``'s quota/shutdown/never-drop protocol (checkout
    via ``producer_done``, hard ``close()`` on error) — it just sources
    payloads from its worker's ``ready_q`` instead of collecting them
    itself, wrapping the shm staging set each descriptor points at into a
    zero-copy ``Rollout`` whose ``release`` returns the set index to the
    worker's free list. ``final_state`` is the worker's acting-generator
    state after a completed quota.
    """

    def __init__(self, worker: _WorkerHandle, queue, telemetry=None,
                 actor_id: Optional[int] = None, ledger=None,
                 lockstep: bool = False):
        # actor_id can differ from the worker's slot: a respawned replica
        # gets a fresh epoch id while the child keeps its slot (which is
        # also its shm reader_id)
        super().__init__(queue,
                         worker.actor_id if actor_id is None else actor_id,
                         telemetry=telemetry)
        self._worker = worker
        self._telemetry = telemetry
        self.slot_index = worker.actor_id
        self._ledger = ledger
        self._lockstep = lockstep
        # the seq offset of a ledger continuation: the child restarts its
        # local seq at 0 a run command, the stream must not
        self._seq_base = 0
        self.final_state: Optional[bytes] = None

    def stop(self) -> None:
        super().stop()
        self._worker.stop_evt.set()  # reaches the child's blocking loops

    def _next_msg(self) -> Tuple:
        while True:
            try:
                return self._worker.ready_q.get(timeout=0.1)
            except _stdlib_queue.Empty:
                if not self._worker.proc.is_alive():
                    raise RuntimeError(
                        f"actor worker {self.slot_index} died without a "
                        f"message (exitcode {self._worker.proc.exitcode}) — "
                        "envs or shm torn down underneath it?") from None

    def _produce(self) -> None:
        discard = False  # after stop/close: recycle sets, put nothing
        while True:
            msg = self._next_msg()
            kind = msg[0]
            if kind == "rollout":
                idx, seq, version = msg[1], msg[2], msg[3]
                free_q = self._worker.free_q
                if discard or self._stop_requested.is_set():
                    free_q.put(idx)  # keep the child's lease flowing
                    discard = True
                    continue
                s = self._worker.sets[idx]
                if not self._put(Rollout(
                        s.traj, s.last_obs, version, self.actor_id,
                        self._seq_base + seq,
                        release=(lambda i=idx: free_q.put(i)))):
                    free_q.put(idx)
                    discard = True  # drain to the terminal message
                else:
                    self.produced += 1
                    if self._ledger is not None:
                        self._ledger.produced()
            elif kind == "spans":
                # the child's span ring, shipped just before its terminal
                # message: a trace track of its own process
                if self._telemetry is not None:
                    self._telemetry.merge_shipped(msg[1],
                                                  pid=self.slot_index + 1)
            elif kind == "done":
                self.final_state = msg[1]
                if self._ledger is not None and not discard \
                        and not self._stop_requested.is_set():
                    # quota done — a dead sibling may have orphaned more:
                    # claim it and send the idle child another run command
                    got = self._ledger.wait_for_work(
                        stop=self._stop_requested.is_set)
                    if got > 0:
                        extra = got + self._ledger.claim()
                        self._seq_base = self.produced
                        self.assigned += extra
                        self._worker.cmd_q.put(
                            ("run", int(extra), self._lockstep, ()))
                        continue
                return  # graceful checkout (ActorBase -> producer_done)
            elif kind == "aborted":
                return
            elif kind == "error":
                raise RuntimeError(
                    f"actor worker {self.slot_index} failed:\n{msg[1]}")
            else:  # a protocol violation
                raise RuntimeError(f"unknown worker message {msg!r}")


class _ShmSlotBridge:
    """Learner-facing twin of ``PingPongParamSlot`` for the process plane.

    ``reserve`` waits out the *cross-process* readers of shm buffer
    ``v % 2`` and hands back the learner-side stale buffer (the target the
    learner step writes the published copy into, exactly like the thread
    slot); ``commit`` keeps that copy and lands it in shared memory — the
    one D2H param copy an update that broadcasting to subprocesses costs.
    No in-process readers exist, so the learner-side buffers need no
    reader counts.
    """

    def __init__(self, params: Any, shm_slot: ShmParamSlot, emitter=None):
        self._bufs = [_copy_tree(params), _copy_tree(params)]
        self._shm = shm_slot
        self._emitter = emitter  # learner-thread-only writer (no lock)

    def reserve(self, version: int, timeout: Optional[float] = None):
        if not self._shm.reserve(version, timeout=timeout):
            return None
        return self._bufs[version % 2]

    def holders(self, idx: int) -> List[str]:
        """Which workers still lease shm buffer ``idx``."""
        return self._shm.holders(idx)

    def commit(self, published: Any, version: int) -> None:
        self._bufs[version % 2] = published
        if self._emitter is None:
            with sanitize.allowed("shm param publish"):
                self._shm.commit(published, version)
            return
        # the one D2H param copy an update the process plane costs: its
        # own shm.copy span on the publish track, and an intended host sync,
        # so it escapes the learner loop's guard
        self._emitter.begin(SHM_COPY)
        try:
            with sanitize.allowed("shm param publish"):
                self._shm.commit(published, version)
        finally:
            self._emitter.end()


class ProcessActorPlane:
    """Owner of the worker subprocesses and their shared-memory estate.

    Spawned once a ``PipelinedRL`` (process backend): allocates the param
    slot and each worker's staging sets, validates and ships each
    ``HostEnvSpec``, and keeps the children alive across ``run()`` calls.
    ``begin_run`` republishes the current params as version 0, hands each
    worker its quota, and returns the learner-side slot bridge plus one
    ``ProcessActorDrainer`` a worker; ``close`` is the orderly teardown
    (stop command, bounded join, terminate stragglers, unlink shm).
    ``gen_states`` holds each worker's acting-generator state (bytes);
    a respawned worker's comes from ``SeedSequence([seed, slot, epoch])``.
    """

    def __init__(self, specs: Sequence[HostEnvSpec], agent, queue_depth: int,
                 params: Any, gen_states: Sequence[bytes],
                 seed: int = 0) -> None:
        if len(gen_states) != len(specs):
            raise ValueError("one generator state a worker spec required")
        self._ctx = mp.get_context("spawn")
        self._closed = False
        self._workers: List[_WorkerHandle] = []
        # retired handles of dead workers: their staging sets may still back
        # payloads in flight (and their free_q still receives those
        # payloads' release()s), so their estate is torn down only at close
        self._graveyard: List[_WorkerHandle] = []
        self._slot = ShmParamSlot(params, self._ctx,
                                  max_readers=max(len(specs), 1))
        self._n_sets = queue_depth + 2  # the HostStagingRing sizing contract
        self._specs = list(specs)
        self._agent = agent
        self._settings = torch_settings()
        self._seed = int(seed)
        self._epochs = [0] * len(specs)  # respawn generation a slot
        _LIVE_PLANES.add(self)
        try:
            for i, spec in enumerate(specs):
                spec.validate_picklable()
                self._workers.append(self._spawn(i, gen_states[i]))
        except BaseException:
            self.close()
            raise

    def _spawn(self, slot_idx: int, gen_state: bytes) -> _WorkerHandle:
        """Allocate one worker's estate (staging sets, queues, stop event),
        start its process and return its handle. The child's actor_id is
        its slot index — also its shm param reader_id and its trace
        track."""
        spec = self._specs[slot_idx]
        sets = [ShmStagingSet(self._agent.hp.t_max, spec.n_envs,
                              spec.obs_shape, spec.obs_dtype)
                for _ in range(self._n_sets)]
        cmd_q = self._ctx.Queue()
        ready_q = self._ctx.Queue()
        free_q = self._ctx.Queue()
        for j in range(self._n_sets):
            free_q.put(j)
        stop_evt = self._ctx.Event()
        epoch = self._epochs[slot_idx]
        proc = self._ctx.Process(
            target=_worker_main,
            args=(spec, self._agent.cfg, self._agent.hp, self._slot.handle(),
                  [s.name for s in sets], gen_state, self._settings,
                  cmd_q, ready_q, free_q, stop_evt, slot_idx),
            name=(f"pipeline-worker-{slot_idx}" if epoch == 0
                  else f"pipeline-worker-{slot_idx}e{epoch}"),
            daemon=True,  # orphan reaping: die with the parent
        )
        handle = _WorkerHandle(slot_idx, proc, cmd_q, ready_q, free_q,
                               stop_evt, sets)
        try:
            proc.start()
        except BaseException:
            self._graveyard.append(handle)  # close() tears its estate down
            raise
        return handle

    def _respawn_state(self, slot_idx: int) -> bytes:
        """A fresh acting-generator state for slot ``slot_idx``'s current
        epoch, on its spec's device: deterministic a (seed, slot, epoch),
        never a replay of an earlier epoch's draws."""
        ss = np.random.SeedSequence([self._seed, slot_idx,
                                     self._epochs[slot_idx]])
        g = torch.Generator(device=self._specs[slot_idx].device)
        g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
        return generator_state(g)

    def segment_names(self) -> List[str]:
        """Every shm segment of this plane: the staging sets of the live
        workers and of the graveyard, and the param slot."""
        return ([s.name for w in self._handles() for s in w.sets]
                + list(self._slot.segment_names))

    def _handles(self) -> List[_WorkerHandle]:
        """The live workers' handles and the graveyard's, each once (a slot
        whose fresh spawn failed keeps its retired handle in both)."""
        out: List[_WorkerHandle] = []
        for w in self._workers + self._graveyard:
            if all(w is not o for o in out):
                out.append(w)
        return out

    def begin_run(self, queue, quota: Sequence[int], lockstep: bool,
                  params: Any, telemetry=None, ledger=None, injector=None):
        """Start one ``run()``'s worth of collection on every worker.

        Returns ``(slot, drainers)`` with ``slot`` speaking the learner
        loop's reserve/commit protocol. The version counter rewinds to 0
        each run (workers are idle between runs, so no reader can hold a
        stale lease across the reset) — like the thread plane building a
        fresh ``PingPongParamSlot`` a run. With a ``telemetry`` hub the
        drainers merge each worker's shipped span ring into it and the
        slot bridge spans its D2H publish copy an update. A ``ledger`` goes
        to the drainers (supervised runs); an ``injector`` ships each worker
        its planned kills in its run command.
        """
        if self._closed:
            raise RuntimeError("begin_run() on a closed ProcessActorPlane")
        self._slot.publish(params, 0)
        drainers = []
        for w, q in zip(self._workers, quota):
            w.stop_evt.clear()
            faults = (injector.kills_for_worker(w.actor_id)
                      if injector is not None else ())
            w.cmd_q.put(("run", int(q), bool(lockstep), faults))
            d = ProcessActorDrainer(w, queue, telemetry=telemetry,
                                    ledger=ledger, lockstep=bool(lockstep))
            d.assigned = int(q)
            drainers.append(d)
        publish_em = (telemetry.emitter("shm.publish")
                      if telemetry is not None else None)
        return _ShmSlotBridge(params, self._slot, emitter=publish_em), drainers

    def respawn_worker(self, slot_idx: int, actor_id: int, quota: int,
                       lockstep: bool, queue, telemetry=None, ledger=None):
        """Stand a dead slot back up mid-run (the supervisor's path).

        Clears the dead replica's leaked param lease, then either reuses
        the child while it lives (an injected or in-child error leaves it
        parked at its command loop) or retires its handle to the graveyard
        and spawns a fresh process with a fresh shm estate and a generator
        state derived from (seed, slot, epoch). Returns a
        ``ProcessActorDrainer`` under the fresh epoch ``actor_id``, not
        started: the caller starts it.
        """
        if self._closed:
            raise RuntimeError("respawn_worker() on a closed plane")
        self._slot.revoke(slot_idx)
        self._epochs[slot_idx] += 1
        w = self._workers[slot_idx]
        if not w.proc.is_alive():
            w.proc.join(timeout=1.0)
            self._graveyard.append(w)
            w = self._spawn(slot_idx, self._respawn_state(slot_idx))
            self._workers[slot_idx] = w
        w.stop_evt.clear()
        w.cmd_q.put(("run", int(quota), bool(lockstep), ()))
        d = ProcessActorDrainer(w, queue, telemetry=telemetry,
                                actor_id=actor_id, ledger=ledger,
                                lockstep=bool(lockstep))
        d.assigned = int(quota)
        return d

    def close(self, join_timeout: float = 10.0) -> None:
        """Stop workers (politely, then hard) and release the shm estate —
        the graveyard's included. Idempotent; safe with workers already
        dead."""
        if self._closed:
            return
        self._closed = True
        _LIVE_PLANES.discard(self)
        handles = self._handles()
        for w in handles:
            w.stop_evt.set()
            try:
                w.cmd_q.put(("stop",))
            except (ValueError, OSError):  # queue already torn down
                pass
        for w in handles:
            if w.proc.pid is not None:
                w.proc.join(timeout=join_timeout)
                if w.proc.is_alive():  # hung child: reap it hard
                    w.proc.terminate()
                    w.proc.join(timeout=join_timeout)
        for w in handles:
            for q in (w.cmd_q, w.ready_q, w.free_q):
                q.cancel_join_thread()
                q.close()
            for s in w.sets:
                s.close()
                s.unlink()
        self._slot.close()
        self._slot.unlink()


# The interpreter-exit reaper: CPython gives no ordering (or execution)
# guarantee for __del__ at shutdown — a plane caught in a reference cycle
# would be torn down after the shm module's globals were cleared, or not
# at all, leaking /dev/shm segments and child processes. One atexit hook
# over a WeakSet runs while the interpreter is still whole; a plane closed
# normally has already removed itself.
_LIVE_PLANES: "weakref.WeakSet" = weakref.WeakSet()


def _reap_planes() -> None:
    for plane in list(_LIVE_PLANES):
        try:
            plane.close(join_timeout=1.0)
        except Exception:
            pass


atexit.register(_reap_planes)

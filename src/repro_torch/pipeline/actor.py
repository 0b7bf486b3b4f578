"""The pipeline's acting half: rollout collection decoupled from learning
(a port of ``repro.pipeline.actor``, with the thread backend).

Two collection paths, mirroring the two environment regimes of
``repro_torch.core.framework``:

* ``make_collect_fn`` (re-exported from ``repro_torch.core.rollout``) —
  batched tensor ``VectorEnv``: the collect runs on the device and its
  output feeds the device ring without touching host memory.
* ``collect_host`` — ``HostEnvPool``: batched acting on the device
  interleaved with threaded host env stepping (paper §3's master/worker
  loop, run on the actor thread). Trajectories are written row by row
  into reusable ``HostStagingRing`` sets — page-locked memory on a CUDA
  run, so the learner's copy to the card is one asynchronous transfer a
  field — and each acting step brings action, value and log-prob back to
  the host in one packed copy, the one read-back a step that the env
  workers need.

``ParamSlot`` is the basic learner→actor exchange (a reference swap).
``PingPongParamSlot`` is its safe upgrade: the learner's working params
are *never* handed to actors — each update lands a bitwise copy in one of
two alternating actor-facing buffers, and actors bracket their rollouts
with ``acquire``/``release`` read leases, so the learner overwrites the
stale buffer in place only once nobody reads it.

``Rollout`` is the queue payload: the trajectory, the bootstrap
observation, the behaviour params version (staleness = learner_version −
behaviour_version), the producing replica and its sequence number, and on
the host plane the ``release`` hook that hands its staging set back.

``ActorThread`` is one replica on its own thread. On the card the
reference's ordering through XLA buffers becomes CUDA stream order:

* each replica collects on its own ``torch.cuda.Stream`` (on the host
  plane the obs copy of each acting step goes there too);
* ``commit`` records an event on the learner's stream after the copy into
  a ping-pong buffer and ``acquire`` returns it: the replica's stream
  waits on it before its first forward, so it never reads a half-written
  buffer;
* after the collect the replica records an event on its stream and waits
  for it on the host *before* it releases the lease: then ``reserve``'s
  host-side wait for readers also covers their device reads, and the ring
  depth really bounds the rollouts in flight (the reference's
  ``block_until_ready`` before release). The event rides the payload, and
  the learner's stream waits on it before reading
  (``repro_torch.pipeline.ring.adopt``). A host-plane collect has already
  waited for its device work when it returns, so its payload carries none.

Fault tolerance (``repro_torch.pipeline.supervisor``, ``faults``): a
replica that dies consults its ``supervisor`` on its own thread before it
hard-closes the stream; ``ActorThread`` takes the run's quota ledger (it
picks up a dead sibling's orphaned quota once its own is done), the fault
injector (the planned kills fire before a collect) and a ``snapshot`` hook
whose post-collect resume state the learner pops with ``consume_state`` as
it consumes the matching payload. A torch generator advances in place
during a collect (a JAX key is replaced only on success), so a replica
also keeps ``boundary``: its generators' states after its last
successful collect, from which a respawn builds fresh generators.
"""
from __future__ import annotations

import contextlib
import threading
from queue import Full
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.lockcheck import make_condition, make_lock
from repro_torch.core.rollout import (Transition, behaviour_logp,
                                      make_collect_fn)
from repro_torch.pipeline.queue import QueueClosed
from repro_torch.telemetry.spans import (COLLECT, LEASE, QUEUE_PUT_WAIT,
                                         SpanEmitter)
from repro_torch.utils.sampling import categorical, generator_state
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = [
    "ParamSlot",
    "PingPongParamSlot",
    "HostStagingRing",
    "StagingSet",
    "Rollout",
    "ActorBase",
    "ActorThread",
    "collect_host",
    "make_collect_fn",
    "make_host_act_step",
    "record_event",
    "staging_fields",
]


def record_event(tree) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded on the current stream of the card that
    ``tree``'s first CUDA tensor lives on; ``None`` when no tensor of
    ``tree`` lives on a card."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            with torch.cuda.device(leaf.device):
                return torch.cuda.current_stream().record_event()
    return None


def on_stream(stream):
    """``torch.cuda.stream(stream)``, or nothing for ``None`` (the CPU)."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


class ParamSlot:
    """Versioned single-slot param exchange (learner → actor).

    The learner ``publish``es params after every update; the actor
    ``acquire``s whatever is newest when it starts a rollout. ``wait_for``
    lets a lock-stepped actor block until the learner has caught up —
    synchronous semantics through the pipelined code path.

    ``acquire`` returns ``(params, version, ready)``: ``ready`` is the CUDA
    event after which the params may be read, ``None`` here (the publisher
    orders its own stream) and on the CPU. ``release`` is a no-op here:
    reference-swapped params are never overwritten, so holding them needs
    no protection.
    """

    def __init__(self, params: Any, version: int = 0):
        self._params = params
        self._version = version
        self._cond = make_condition("param_slot.cond")

    def publish(self, params: Any, version: int) -> None:
        with self._cond:
            self._params = params
            self._version = version
            self._cond.notify_all()

    def read(self) -> Tuple[Any, int]:
        with self._cond:
            return self._params, self._version

    def acquire(self, holder: Optional[str] = None):
        """Take a read lease on the newest params (paired with
        ``release``); returns ``(params, version, ready)``. ``holder``
        labels the leasing party for timeout diagnostics."""
        with self._cond:
            return self._params, self._version, None

    def release(self, version: int, holder: Optional[str] = None) -> None:
        """Return the lease taken by ``acquire`` (no-op for the base slot)."""

    def wait_for(self, version: int, timeout: Optional[float] = None) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self._version >= version,
                                       timeout=timeout)

    @property
    def version(self) -> int:
        with self._cond:
            return self._version


@torch.no_grad()
def _copy_tree(tree):
    return tree_map(lambda a: a.detach().clone(), tree)


class PingPongParamSlot(ParamSlot):
    """Two alternating actor-facing param buffers with read leases.

    The hazard: if actors read the learner's working params, the next
    update replaces or overwrites them under an in-flight rollout. So the
    learner's params are never shared: ``publish`` of version ``v`` lands a
    bitwise copy in buffer ``v % 2``, actors lease the newest buffer for
    exactly one rollout, and the learner ``reserve``s a buffer for reuse
    only after its last reader released. The learner writes the new params
    into the reserved buffer in place — one param copy per update, no
    allocation.

    Lease protocol (actor side)::

        params, version, ready = slot.acquire()   # readers[v % 2] += 1
        try:  ... wait on ready, collect with params, wait for the collect
        finally: slot.release(version)            # readers[v % 2] -= 1

    Publish protocol (learner side, per update ``v``)::

        dst = slot.reserve(v)     # blocks until readers[v % 2] == 0
        ... copy the new params into dst in place ...
        slot.commit(dst, v)       # records the ready event, notifies

    ``reserve`` can only wait on a reader that is mid-rollout — actors
    release before blocking on the ring — so the wait is bounded by one
    collect and cannot deadlock.
    """

    def __init__(self, params: Any, version: int = 0):
        # actors only ever see copies; the caller keeps the original as the
        # learner's private working params
        bufs = [_copy_tree(params), _copy_tree(params)]
        super().__init__(bufs[version % 2], version)
        self._bufs = bufs
        ready = record_event(bufs)  # both copies are done after it
        self._events = [ready, ready]
        self._readers = [0, 0]
        # per-buffer holder labels, parallel to _readers: a reserve that
        # times out names *who* never released
        self._holders: dict = {0: [], 1: []}

    def acquire(self, holder: Optional[str] = None):
        with self._cond:
            idx = self._version % 2
            self._readers[idx] += 1
            if holder is not None:
                self._holders[idx].append(holder)
            return self._params, self._version, self._events[idx]

    def release(self, version: int, holder: Optional[str] = None) -> None:
        with self._cond:
            idx = version % 2
            self._readers[idx] -= 1
            assert self._readers[idx] >= 0, "unbalanced release"
            if holder is not None:
                try:
                    self._holders[idx].remove(holder)
                except ValueError:
                    pass  # unlabeled acquire / already revoked
            self._cond.notify_all()

    def holders(self, idx: int) -> List[str]:
        """Labels of the parties currently leasing buffer ``idx``."""
        with self._cond:
            return list(self._holders[idx])

    def revoke(self, holder: str) -> int:
        """Drop every lease ``holder`` still holds (a replica that died
        without releasing). Returns the leases cleared."""
        cleared = 0
        with self._cond:
            for idx in (0, 1):
                while holder in self._holders[idx]:
                    self._holders[idx].remove(holder)
                    self._readers[idx] -= 1
                    cleared += 1
            if cleared:
                self._cond.notify_all()
        return cleared

    def reserve(self, version: int, timeout: Optional[float] = None):
        """Claim buffer ``version % 2`` for the upcoming publish.

        Blocks until every reader of the buffer's previous contents has
        released — and an actor releases only after its device reads have
        finished — then returns the stale param tree to overwrite in place.
        Returns ``None`` on timeout.
        """
        idx = version % 2
        with self._cond:
            if not self._cond.wait_for(lambda: self._readers[idx] == 0,
                                       timeout=timeout):
                return None
            return self._bufs[idx]

    def commit(self, params: Any, version: int) -> None:
        """Install the published copy (written into ``reserve``'s target)
        and record, on the committing thread's current stream, the event
        after which actors may read it."""
        idx = version % 2
        with self._cond:
            assert self._readers[idx] == 0, "commit while buffer leased"
            self._bufs[idx] = params
            self._events[idx] = record_event(params)
            self._params = params
            self._version = version
            self._cond.notify_all()

    def publish(self, params: Any, version: int,
                timeout: Optional[float] = 60.0) -> None:
        """Unfused publish: copy ``params`` into the alternating buffer.

        Blocks for the buffer's readers, copies in place, commits. A
        reserve timeout means a reader never released its lease — raise
        loudly rather than write over a still-leased buffer (which would
        hand actors a tree mutating under them). The copy runs on the
        caller's current stream, and ``commit`` records the event after
        it."""
        dst = self.reserve(version, timeout=timeout)
        if dst is None:
            held = ", ".join(self.holders(version % 2)) or "an unlabeled party"
            raise RuntimeError(
                f"PingPongParamSlot.publish(version={version}): reserve "
                f"timed out after {timeout}s — buffer {version % 2} is "
                f"still leased by {held} (died without release()?)")
        assert dst is self._bufs[version % 2], (
            "reserve() returned a tree that is not the reserved buffer")
        with torch.no_grad():
            for d, s in zip(tree_leaves(dst), tree_leaves(params)):
                d.copy_(s)
        self.commit(dst, version)


class Rollout(NamedTuple):
    """Ring payload: one collected rollout plus its provenance.

    ``actor_id``/``seq`` tag which replica produced the rollout and where it
    sits in that replica's stream — the learner uses them to attribute
    staleness, and the tests to prove every ``(actor_id, seq)`` is learned
    exactly once. ``release`` returns the payload's host staging set to its
    ring on the host plane, once the learner has consumed the update; it is
    ``None`` on the device plane. ``ready`` is the CUDA event recorded on
    the actor's stream after the collect (``None`` on the CPU and on the
    host plane, whose collect has waited for its device work)."""

    traj: Transition  # time-major (T, E, ...)
    last_obs: torch.Tensor  # (E, *obs_shape) — bootstrap observation
    behavior_version: int  # params version the actor acted with
    actor_id: int = 0  # which actor replica collected it
    seq: int = 0  # per-actor rollout sequence number
    release: Optional[Callable[[], None]] = None  # staging-set return hook
    ready: Any = None  # CUDA event after the collect, or None


# ---------------------------------------------------------------------------
# Host staging — reusable page-locked buffers for host-plane payloads
# ---------------------------------------------------------------------------


def staging_fields(t_max: int, n_envs: int, obs_shape: Tuple[int, ...],
                   obs_dtype) -> List[Tuple[Tuple[int, ...], np.dtype]]:
    """The staging-payload layout: ``Transition``'s six fields (in field
    order) followed by the bootstrap ``last_obs``. Actions are int64, the
    dtype the port's learner gathers with (the reference stages int32)."""
    E = n_envs
    obs_shape = tuple(obs_shape)
    obs_dtype = np.dtype(obs_dtype)
    return [
        ((t_max, E) + obs_shape, obs_dtype),      # Transition.obs
        ((t_max, E), np.dtype(np.int64)),         # Transition.action
        ((t_max, E), np.dtype(np.float32)),       # Transition.reward
        ((t_max, E), np.dtype(bool)),             # Transition.done
        ((t_max, E), np.dtype(np.float32)),       # Transition.value
        ((t_max, E), np.dtype(np.float32)),       # Transition.logp
        ((E,) + obs_shape, obs_dtype),            # last_obs
    ]


def _host_tensor(shape, dtype: np.dtype, pin_memory: bool) -> torch.Tensor:
    tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.zeros(shape, dtype=tdtype, pin_memory=pin_memory)


class StagingSet:
    """One reusable host payload: a ``(t_max, E, ...)`` trajectory plus the
    bootstrap observation, written in place row by row during collection.

    ``traj``/``last_obs`` are CPU tensors — page-locked with ``pin_memory``
    (a CUDA run), so their copies to the card can be asynchronous — and
    ``np_traj``/``np_last_obs`` numpy views of the same memory, which the
    host loop and the env workers write."""

    __slots__ = ("traj", "last_obs", "np_traj", "np_last_obs")

    def __init__(self, t_max: int, n_envs: int, obs_shape: Tuple[int, ...],
                 obs_dtype, pin_memory: bool = False):
        tensors = [_host_tensor(shape, dtype, pin_memory) for shape, dtype in
                   staging_fields(t_max, n_envs, obs_shape, obs_dtype)]
        self.traj = Transition(*tensors[:6])
        self.last_obs = tensors[6]
        self.np_traj = Transition(*(t.numpy() for t in tensors[:6]))
        self.np_last_obs = tensors[6].numpy()


def to_device(traj: Transition, last_obs: torch.Tensor, device):
    """A staged payload's copy to ``device``: one transfer a field, on the
    current stream, asynchronous from page-locked memory. The staging set
    must stay untouched until the work that reads the copies has finished
    (the ``Rollout.release`` protocol). On the CPU the tensors come back
    as they are."""
    return (Transition(*(t.to(device, non_blocking=True) for t in traj)),
            last_obs.to(device, non_blocking=True))


class HostStagingRing:
    """Pool of reusable staging sets for one actor's host-plane rollouts.

    Collection writes into preallocated sets instead of stacking per-step
    copies: ``acquire`` hands out a free set, the payload's ``release``
    callback (invoked by the learner after it has consumed the update, i.e.
    after the copy to the card has provably finished) returns it.
    ``n_sets`` must cover every set simultaneously in flight: up to
    ``queue_depth`` enqueued + 1 consumed-but-unreleased + 1 being written,
    so callers size it ``queue_depth + 2``. ``acquire`` never blocks when
    that invariant holds; a blocked acquire is a release-protocol bug, which
    the timeout turns into a loud error instead of a hang.
    """

    def __init__(self, n_sets: int, t_max: int, n_envs: int,
                 obs_shape: Tuple[int, ...], obs_dtype=np.float32,
                 pin_memory: bool = False):
        if n_sets < 2:
            raise ValueError(f"staging ring needs >= 2 sets, got {n_sets}")
        self._free: List[StagingSet] = [
            StagingSet(t_max, n_envs, obs_shape, obs_dtype, pin_memory)
            for _ in range(n_sets)
        ]
        self.n_sets = n_sets
        self._cond = make_condition("staging_ring.cond")

    def acquire(self, timeout: float = 60.0) -> StagingSet:
        with self._cond:
            if not self._cond.wait_for(lambda: self._free, timeout=timeout):
                raise RuntimeError(
                    "HostStagingRing.acquire timed out — a payload was "
                    "consumed without its release() being called"
                )
            return self._free.pop()

    def release(self, s: StagingSet) -> None:
        with self._cond:
            self._free.append(s)
            self._cond.notify_all()

    def free_sets(self) -> int:
        with self._cond:
            return len(self._free)


def make_host_act_step(act_fn: Callable) -> Callable:
    """One acting step — forward, draw, behaviour logp — for the host loop:
    ``act_step(params, obs, generator, action=None) -> (action, value,
    logp)``. The draw comes from the explicit ``generator``; ``action``,
    if given, replaces it (a test seam that replays another run's
    actions). ``logp`` is the sampled action's logit minus the logsumexp,
    the gather of ``core.rollout.behaviour_logp``."""

    @torch.no_grad()
    def act_step(params, obs, generator, action=None):
        logits, value = act_fn(params, obs)
        if action is None:
            action = categorical(logits, generator)
        else:
            action = torch.as_tensor(action, dtype=torch.int64,
                                     device=logits.device)
        return action, value, behaviour_logp(logits, action)

    return act_step


def collect_host(act_step: Callable, pool, params, obs, generator,
                 t_max: int, staging: Optional[StagingSet] = None,
                 actions=None):
    """Collect ``t_max`` steps from a ``HostEnvPool`` (paper §3 loop).

    ``act_step`` is ``make_host_act_step``'s step, run on ``pool.device``;
    env stepping runs on the pool's worker threads. ``obs`` is the carried
    observation, a tensor or a numpy array. Returns ``(next_obs, traj,
    last_obs)``: ``traj`` a time-major ``Transition`` of *host* tensors,
    including the behaviour log-prob the learner's correction needs, and
    ``last_obs`` the bootstrap observation — both the staging set's own
    memory, copied to the card only by the learner — and ``next_obs`` the
    pool's shared observation buffer, to carry into the next collect (it
    stays valid until the pool's next step, and no staging set holds it).

    Each step copies its observation row to the device (on the current
    stream, asynchronously from page-locked memory), acts, and brings
    action, value and logp back in one packed copy: the workers need the
    actions on the host, and that read-back also waits for the step's
    device work. With ``staging`` every step writes its rows directly into
    the set's buffers; the caller must not reuse the set until the learner
    has consumed the payload. Without it each call allocates a fresh set.
    ``actions`` (T, E), if given, replaces the draws.
    """
    if staging is None:
        staging = StagingSet(t_max, pool.n_envs, pool.obs_shape,
                             pool.obs_dtype, pool.device.type == "cuda")
    traj = staging.np_traj
    if isinstance(obs, torch.Tensor):
        staging.traj.obs[0].copy_(obs)
    else:
        np.copyto(traj.obs[0], obs)
    for t in range(t_max):
        obs_t = staging.traj.obs[t].to(pool.device, non_blocking=True)
        action, value, logp = act_step(
            params, obs_t, generator, None if actions is None else actions[t])
        # the step's one read-back; actions are exact in float32 (< 2**24)
        packed = torch.stack([action.float(), value.float(),
                              logp.float()]).cpu().numpy()
        action_np = packed[0].astype(np.int64)
        next_obs, reward, done = pool.step_host(action_np)
        traj.action[t] = action_np
        traj.reward[t] = reward
        traj.done[t] = done
        traj.value[t] = packed[1]
        traj.logp[t] = packed[2]
        np.copyto(traj.obs[t + 1] if t + 1 < t_max else staging.np_last_obs,
                  next_obs)
    return next_obs, staging.traj, staging.last_obs


class ActorBase(threading.Thread):
    """Shared replica protocol.

    * **quota** — produce exactly ``assigned`` payloads (possibly zero: a
      replica handed quota 0 by an ``iterations < num_actors`` run goes
      straight to checkout),
    * **never-drop** — every produced payload is ``_put`` into the shared
      stream, which blocks (backpressure) rather than discards,
    * **shutdown** — finishing the quota (or being ``stop()``ed, or finding
      the stream closed underneath) checks out via ``producer_done()``; the
      stream closes only after the *last* replica checks out. A replica
      that dies records its exception and hard-``close()``s the stream so
      the learner and sibling replicas unwind promptly instead of
      deadlocking.

    Subclasses implement ``_produce()``.
    """

    def __init__(self, queue, actor_id: int = 0, telemetry=None):
        super().__init__(name=f"pipeline-actor-{actor_id}", daemon=True)
        self._queue = queue
        self.actor_id = actor_id
        self._stop_requested = threading.Event()
        # this replica's span track (single-writer: only this thread
        # records); wait_s/put_wait_s are derived from its totals
        if telemetry is not None:
            self.span_emitter = telemetry.emitter(f"actor{actor_id}")
        else:
            self.span_emitter = SpanEmitter(f"actor{actor_id}")
        self.error: Optional[BaseException] = None
        # the fault-tolerance surface (repro_torch.pipeline.supervisor): the
        # slot this replica occupies (stable across respawns, unlike
        # actor_id), its quota accounting, and the supervisor the epilogue
        # consults. A handled fault leaves ``error`` set (diagnostics) but
        # marks ``fault_handled``, so the run does not treat it as fatal.
        self.slot_index = actor_id
        self.assigned = 0  # payloads this replica must produce
        self.produced = 0  # payloads successfully put so far
        self.supervisor = None
        self.fault_handled = False

    @property
    def wait_s(self) -> float:
        """Time blocked waiting for params (lockstep) — span-derived."""
        return self.span_emitter.total(LEASE)

    @property
    def put_wait_s(self) -> float:
        """Time blocked in queue.put (backpressure) — span-derived."""
        return self.span_emitter.total(QUEUE_PUT_WAIT)

    def stop(self) -> None:
        """Ask the actor to exit at its next blocking point (learner died)."""
        self._stop_requested.set()

    # hot-path
    def _put(self, rollout: Rollout) -> bool:
        """Bounded put, interruptible by stop()/close(). Returns False when
        the actor should exit instead of producing more."""
        self.span_emitter.begin(QUEUE_PUT_WAIT)
        try:
            while True:
                try:
                    self._queue.put(rollout, timeout=0.1)
                    return True
                except Full:
                    if self._stop_requested.is_set():
                        return False
                except QueueClosed:
                    return False  # stream aborted under us — not our error
        finally:
            self.span_emitter.end()

    def _produce(self) -> None:
        raise NotImplementedError

    def run(self) -> None:
        try:
            self._produce()
        except BaseException as e:  # surfaced by the learner loop
            self.error = e
        finally:
            if self.error is not None:
                # with a supervisor the dying thread *is* the recovery
                # context: on_actor_error respawns a replacement (which
                # inherits this replica's producer slot) or degrades by
                # orphaning the remaining quota (checking the slot out
                # itself). Only an unhandled death hard-aborts the stream.
                sup = self.supervisor
                if sup is not None and sup.on_actor_error(self):
                    self.fault_handled = True
                else:
                    self._queue.close()  # abort: wake learner + siblings
            else:
                self._queue.producer_done()


class ActorThread(ActorBase):
    """One in-process actor replica: collects ``iterations`` rollouts on its
    own thread (and, on the card, its own CUDA ``stream``) and feeds the
    shared trajectory ring.

    ``collect(params, key) -> (key, traj, last_obs, release)`` encapsulates
    the collection with env state captured in the closure; ``key`` is the
    replica's ``(act_generator, env_generator)`` pair, owned by this thread.
    Params are taken under an ``acquire``/``release`` lease for exactly the
    duration of the collect — never while blocked on the ring — which is
    what lets a ping-pong slot reuse stale buffers without racing this
    thread. In ``lockstep`` mode the actor waits until the learner has
    published version i before collecting rollout i (so data is never
    stale); otherwise it reads the freshest available params and runs ahead
    up to the ring depth (shared across all replicas).

    Quota and shutdown are ``ActorBase``'s; its process-backend twin
    (``repro_torch.pipeline.worker.ProcessActorDrainer``) shares them.
    """

    def __init__(self, collect: Callable, queue, slot: ParamSlot, key,
                 iterations: int, lockstep: bool = False, actor_id: int = 0,
                 telemetry=None, slot_index: Optional[int] = None,
                 start_seq: int = 0, ledger=None, injector=None,
                 snapshot: Optional[Callable] = None, stream=None,
                 lockstep_base: int = 0):
        super().__init__(queue, actor_id, telemetry=telemetry)
        self._collect = collect
        self._slot = slot
        self._key = key
        self.assigned = iterations
        self._lockstep = lockstep
        self.slot_index = actor_id if slot_index is None else slot_index
        # the seq offset of a resumed run: local rollout index i is tagged
        # ``start_seq + i``, so the (actor_id, seq) stream continues the
        # checkpointed one
        self._start_seq = start_seq
        # lockstep waits for version lockstep_base + i: a replica respawned
        # after its predecessor produced n rollouts of this run starts at n
        self._lockstep_base = lockstep_base
        self._stream = stream
        # the quota ledger (supervised runs): lets this replica pick up a
        # dead sibling's orphaned quota after finishing its own
        self._ledger = ledger
        # deterministic fault injection (FaultPlan), None outside tests
        self._injector = injector
        # checkpoint support: snapshot(key) -> the resume state after each
        # collect; the learner calls consume_state(seq) as it consumes the
        # matching payload, so the log holds at most the in-flight window
        self._snapshot = snapshot
        self._state_log: dict = {}
        self._state_lock = make_lock("actor.state")
        # (act, env) generator states after the last successful collect (a
        # few KB a rollout on the CPU, 16 bytes a generator on the card): a
        # respawn starts from them, never from this replica's generators,
        # which a failed collect leaves advanced
        self.boundary: Optional[Tuple[bytes, ...]] = None

    def consume_state(self, seq: int):
        """Pop (and prune up to) the resume state recorded after rollout
        ``seq``; ``None`` when snapshotting is off or seq predates it."""
        with self._state_lock:
            st = self._state_log.get(seq)
            for k in [k for k in self._state_log if k <= seq]:
                del self._state_log[k]
            return st

    def _mark_boundary(self) -> None:
        self.boundary = tuple(generator_state(g) for g in self._key)

    def _produce(self) -> None:
        self._mark_boundary()
        i = 0  # local rollout index (lockstep waits on it; seq offsets it)
        while True:
            if i >= self.assigned:
                if self._ledger is None:
                    return
                # quota done — but a sibling may have died with quota
                # outstanding: block for orphaned work instead of checking
                # out, until the ledger proves no work can remain
                got = self._ledger.wait_for_work(
                    stop=self._stop_requested.is_set)
                if got <= 0:
                    return
                self.assigned += got
                continue
            if self._injector is not None:
                self._injector.maybe_kill(self.slot_index, self.produced)
                self._injector.lease_delay(self.slot_index, i)
            if self._lockstep:
                # lease span: the stop-abort path cancels instead of ending
                self.span_emitter.begin(LEASE)
                while not self._slot.wait_for(self._lockstep_base + i,
                                              timeout=0.1):
                    if self._stop_requested.is_set():
                        self.span_emitter.cancel()
                        return
                self.span_emitter.end()
            if self._stop_requested.is_set():
                return
            # lease the params only for the collect: released before the
            # (potentially long) blocking put, so the learner's reserve()
            # wait is bounded by one rollout
            params, version, ready = self._slot.acquire(holder=self.name)
            self.span_emitter.begin(COLLECT)
            try:
                with on_stream(self._stream):
                    if ready is not None:  # the publish copy is done first
                        torch.cuda.current_stream().wait_event(ready)
                    self._key, traj, last_obs, release = self._collect(
                        params, self._key)
                    done = record_event(traj)
                if done is not None:
                    # the lease covers the collect's device reads of the
                    # params: wait for them before giving the lease back
                    done.synchronize()
            finally:
                self.span_emitter.end()
                self._slot.release(version, holder=self.name)
            self._mark_boundary()
            seq = self._start_seq + i
            if self._snapshot is not None:
                # the post-rollout state, captured *before* the put (by the
                # time the learner can consume seq, its resume state
                # exists) and after the collect's device work has finished
                with self._state_lock:
                    self._state_log[seq] = self._snapshot(self._key)
            if not self._put(Rollout(traj, last_obs, version, self.actor_id,
                                     seq, release, done)):
                return
            self.produced += 1
            if self._ledger is not None:
                self._ledger.produced()
            i += 1

"""Shared-memory plumbing for the process actor plane (a port of
``repro.pipeline.shm``).

The process backend moves rollout collection into worker subprocesses —
the only way to scale *GIL-holding* Python emulators, where the thread
plane's env stepping serializes no matter how many actor replicas run.
Everything that crosses the process boundary in steady state rides
``multiprocessing.shared_memory``, so the cost a rollout is a memcpy, not
a pickle, and no torch tensor is ever pickled:

* ``ShmStagingSet`` — the process twin of ``repro_torch.pipeline.actor.
  StagingSet``: one ``(t_max, E, ...)`` trajectory plus the bootstrap
  observation, laid out by ``staging_fields`` (int64 actions) in a single
  named block. It has ``StagingSet``'s four attributes — ``traj`` and
  ``last_obs`` are CPU tensors made by ``torch.from_numpy`` over the
  block's numpy views ``np_traj`` and ``np_last_obs`` — so the child's
  ``collect_host(staging=...)`` writes rows in place, and the parent's
  drainer wraps the *same memory* into the ``Rollout`` it queues: the
  payload is never copied or pickled, only its index is. Sets follow the
  ``HostStagingRing`` sizing and lease contract (``queue_depth + 2`` a
  worker); the free list lives in an ``mp.Queue`` of set indices (see
  ``repro_torch.pipeline.worker``), since the lease hops processes.

* ``ShmParamSlot`` — ``PingPongParamSlot``'s reserve/commit protocol over
  shared memory: two alternating param buffers, cross-process reader
  counts a buffer, and a monotone version, all guarded by one
  ``mp.Condition``. The learner ``reserve``s buffer ``v % 2`` (it waits
  until that buffer's readers are gone), ``commit``s the new params into
  it (one device-to-host copy a leaf an update) and bumps the version;
  each worker's ``ShmParamView`` leases a buffer only for as long as it
  takes to copy it onto its own device. Leaves are matched **by path**
  (``repro_torch.utils.tree.tree_paths``): a tree bridged from the JAX
  package orders its keys otherwise than the port's own trees.
  ``ShmParamSlot.handle()`` is the picklable half a spawned child rebuilds
  its ``ShmParamView`` from.

Ownership: the parent creates every segment and is the only process that
``unlink``s (``ShmStagingSet.unlink`` / ``ShmParamSlot.unlink``); children
attach by name and only ever ``close`` their mappings. Attach-side
mappings are untracked (``_attach``) so a child's exit cannot tear down
segments the parent still serves from.

The slot's ``mp`` condition is the lock-order sanitizer's site
``shm.param_slot`` (``make_condition`` with ``inner=ctx.Condition()``):
the parent's acquisitions land in its graph, and a wrapper shipped to a
child feeds the child's own, unreported monitor.
"""
from __future__ import annotations

import math
import os
from multiprocessing import shared_memory
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.lockcheck import make_condition
from repro_torch.core.rollout import Transition
from repro_torch.device import resolve_device
from repro_torch.pipeline.actor import staging_fields
from repro_torch.utils.tree import tree_map, tree_paths

__all__ = ["ShmStagingSet", "ShmParamSlot", "ShmParamHandle", "ShmParamView"]

_ALIGN = 64  # leaf/field alignment inside a block (cache line)


def _attach(name: str) -> shared_memory.SharedMemory:
    """Attach to an existing segment, untracked where the runtime allows.

    Python 3.13's ``track=False`` skips resource-tracker registration for
    attachments. On 3.10–3.12 the attach *is* registered (bpo-39959), but
    workers spawned by ``multiprocessing`` share the parent's tracker
    process, so the duplicate registration collapses into the parent's own
    (``cache`` is a set) and teardown stays balanced: do NOT "fix" this by
    unregistering after attach — that removes the parent's entry from the
    shared tracker and double-frees at unlink."""
    try:
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:  # cpython < 3.13
        return shared_memory.SharedMemory(name=name)


def _quiet_close(shm: shared_memory.SharedMemory) -> None:
    """``shm.close()`` that survives live views. If a numpy view or a
    ``torch.from_numpy`` tensor over it (a carried bootstrap obs, an
    unconsumed payload riding a reference cycle) still pins the mapping,
    ``mmap.close`` raises BufferError — and would keep raising from
    ``SharedMemory.__del__`` at GC time. Detach the bookkeeping instead:
    drop the handle's mmap/fd so no retry ever fires; the mapping itself is
    freed when the last view dies (the views hold the mmap object alive
    until then)."""
    try:
        shm.close()
    except BufferError:
        shm._mmap = None
        if getattr(shm, "_fd", -1) >= 0:
            os.close(shm._fd)
            shm._fd = -1


def _layout(fields: List[Tuple[Tuple[int, ...], np.dtype]]):
    """(offset per field, total bytes) for one aligned shared block."""
    offsets, off = [], 0
    for shape, dtype in fields:
        off = _ALIGN * math.ceil(off / _ALIGN)
        offsets.append(off)
        off += int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    return offsets, max(off, 1)


def _views(shm: shared_memory.SharedMemory, fields,
           offsets) -> List[np.ndarray]:
    out = []
    for (shape, dtype), off in zip(fields, offsets):
        n = int(np.prod(shape, dtype=np.int64))
        out.append(np.frombuffer(shm.buf, dtype=dtype, count=n, offset=off)
                   .reshape(shape))
    return out


class ShmStagingSet:
    """One reusable cross-process rollout payload in a named shm block.

    Same fields and write-in-place discipline as ``StagingSet`` (it
    satisfies ``collect_host``'s ``staging=`` contract), but the parent and
    any child that knows ``self.name`` see the *same* memory. Construct
    with ``create=True`` (parent: allocates, zero-filled) or
    ``create=False`` with the creator's ``name`` (child: attaches).
    """

    def __init__(self, t_max: int, n_envs: int, obs_shape: Tuple[int, ...],
                 obs_dtype, name: Optional[str] = None, create: bool = True):
        # the one layout shared with the thread plane's StagingSet
        fields = staging_fields(t_max, n_envs, obs_shape, obs_dtype)
        offsets, nbytes = _layout(fields)
        if create:
            # POSIX shm is zero-filled on allocation — no memset needed
            self.shm = shared_memory.SharedMemory(create=True, size=nbytes)
        else:
            if name is None:
                raise ValueError("attaching (create=False) requires a name")
            self.shm = _attach(name)
        self.name = self.shm.name
        self._created = create
        views = _views(self.shm, fields, offsets)
        self.np_traj = Transition(*views[:6])
        self.np_last_obs = views[6]
        self.traj = Transition(*(torch.from_numpy(v) for v in views[:6]))
        self.last_obs = torch.from_numpy(views[6])

    def close(self) -> None:
        """Drop this process's mapping. Tolerates live views (the carried
        bootstrap obs, an unconsumed payload): the mmap then stays pinned
        until those die, which is exactly what a teardown wants — never a
        crash in a ``finally``."""
        self.traj = self.last_obs = self.np_traj = self.np_last_obs = None
        _quiet_close(self.shm)

    def unlink(self) -> None:
        """Destroy the segment (creator only, after every mapping closed)."""
        if self._created:
            self.shm.unlink()


class _LeafSpec:
    """Shape/dtype placeholder leaf: lets the param tree's *structure*
    cross the process boundary without shipping a copy of the params — the
    values already live in the shm buffers."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    def __getstate__(self):
        return self.shape, self.dtype.str

    def __setstate__(self, state):
        self.shape = state[0]
        self.dtype = np.dtype(state[1])


def _host_array(leaf) -> np.ndarray:
    """A leaf as a numpy array: tensors through the CPU (a copy off a
    card), numpy arrays as they are. Leaves whose dtype numpy lacks
    (bfloat16) are refused."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("ShmParamSlot stores leaves of numpy dtypes; "
                            "got a bfloat16 tensor")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class ShmParamSlot:
    """Parent half of the cross-process ping-pong param broadcast.

    Mirrors ``PingPongParamSlot``'s learner-side protocol::

        ok = slot.reserve(v)      # blocks until shm readers[v % 2] == 0
        slot.commit(tree, v)      # shm buffer v % 2 <- tree, version = v

    with reader leases taken by worker-side ``ShmParamView.acquire`` /
    ``release``. ``reserve`` returns ``False`` on timeout, never silently
    proceeds. The leaf layout (shapes, dtypes, offsets) is fixed at
    construction from a template tree of tensors or numpy arrays, and
    ``commit`` matches the leaves of the tree it is given to it by path;
    ``handle()`` packages the layout, the two segment names and the shared
    synchronization primitives for a spawned child.
    """

    def __init__(self, template_tree: Any, ctx, version: int = 0,
                 max_readers: int = 16):
        paths = tree_paths(template_tree)
        leaves = [_host_array(leaf) for _, leaf in paths]
        self._paths = [p for p, _ in paths]
        fields = [(a.shape, a.dtype) for a in leaves]
        # what children rebuild the tree from: shape/dtype placeholders with
        # the original structure — bytes to pickle, not a param-sized copy
        specs = iter(_LeafSpec(s, d) for s, d in fields)
        self._spec_tree = tree_map(lambda _: next(specs), template_tree)
        self._offsets, nbytes = _layout(fields)
        self._shms = [shared_memory.SharedMemory(create=True, size=nbytes)
                      for _ in range(2)]
        self._bufs = [_views(s, fields, self._offsets) for s in self._shms]
        self._cond = make_condition("shm.param_slot", inner=ctx.Condition())
        self._version = ctx.Value("q", version, lock=False)
        self._readers = [ctx.Value("i", 0, lock=False) for _ in range(2)]
        # lease counts a reader, parallel to _readers: lease slot j is
        # worker j's outstanding acquires on that buffer. Lets a reserve
        # timeout name the holder, and lets revoke() clear a dead worker's
        # leaked lease instead of deadlocking the learner.
        self._leases = [ctx.Array("i", max_readers, lock=False)
                        for _ in range(2)]
        for buf in self._bufs:  # version 0 is readable before any commit
            for dst, src in zip(buf, leaves):
                np.copyto(dst, src)

    # -- learner side --------------------------------------------------------
    def reserve(self, version: int, timeout: Optional[float] = None) -> bool:
        """Claim shm buffer ``version % 2``: wait out its readers."""
        idx = version % 2
        with self._cond:
            return self._cond.wait_for(
                lambda: self._readers[idx].value == 0, timeout=timeout)

    def commit(self, tree: Any, version: int) -> None:
        """Install ``tree`` (tensors on any device, or numpy arrays) into
        the reserved buffer, leaf by path, and publish ``version``: one
        device-to-host copy a leaf, then notify waiters."""
        idx = version % 2
        by_path = dict(tree_paths(tree))
        if len(by_path) != len(self._paths):
            raise ValueError(f"commit of a tree with {len(by_path)} leaves "
                             f"into a slot of {len(self._paths)}")
        for path, dst in zip(self._paths, self._bufs[idx]):
            src = by_path[path]
            if isinstance(src, torch.Tensor):
                torch.from_numpy(dst).copy_(src.detach())
            else:
                np.copyto(dst, src)
        with self._cond:
            assert self._readers[idx].value == 0, "commit while buffer leased"
            self._version.value = version
            self._cond.notify_all()

    def publish(self, tree: Any, version: int,
                timeout: Optional[float] = 60.0) -> None:
        """reserve + commit, loud on lease starvation (also the run-start
        reset path: workers are idle between runs, so rewinding the version
        to 0 cannot race a reader)."""
        if not self.reserve(version, timeout=timeout):
            held = ", ".join(self.holders(version % 2)) or "an unlabeled party"
            raise RuntimeError(
                f"ShmParamSlot.publish(version={version}): reserve timed "
                f"out after {timeout}s — buffer {version % 2} is still "
                f"leased by {held} (died holding its lease?)")
        self.commit(tree, version)

    def holders(self, idx: int) -> List[str]:
        """Labels of the workers currently leasing shm buffer ``idx``."""
        with self._cond:
            return [f"worker {j}" for j in range(len(self._leases[idx]))
                    if self._leases[idx][j] > 0]

    def revoke(self, reader_id: int) -> int:
        """Clear every lease ``reader_id`` still holds (a worker that died
        mid-acquire). Returns the leases cleared."""
        cleared = 0
        with self._cond:
            for idx in (0, 1):
                n = self._leases[idx][reader_id]
                if n > 0:
                    self._leases[idx][reader_id] = 0
                    self._readers[idx].value -= n
                    cleared += n
            if cleared:
                self._cond.notify_all()
        return cleared

    def handle(self) -> "ShmParamHandle":
        return ShmParamHandle(
            names=tuple(s.name for s in self._shms),
            template=self._spec_tree,
            cond=self._cond,
            version=self._version,
            readers=tuple(self._readers),
            leases=tuple(self._leases),
        )

    @property
    def segment_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self._shms)

    def close(self) -> None:
        self._bufs = None
        for s in self._shms:
            _quiet_close(s)

    def unlink(self) -> None:
        for s in self._shms:
            s.unlink()


class ShmParamHandle:
    """Picklable ingredients for a worker-side ``ShmParamView``.

    ``template`` is the param tree with every leaf replaced by a
    ``_LeafSpec`` — structure and layout only, no values."""

    def __init__(self, names, template, cond, version, readers, leases):
        self.names = names
        self.template = template
        self.cond = cond
        self.version = version
        self.readers = readers
        self.leases = leases  # per buffer, one lease count a reader


class ShmParamView:
    """Worker half: lease-bracketed reads of the newest published params.

    ``acquire`` takes the read lease (``readers[v % 2] += 1``) and returns
    host views of the leased buffer plus its version; the caller copies
    them out and ``release``s. ``read_params`` packages that into one call
    returning a fresh tree of tensors on ``device``, holding the lease only
    for the copy. ``wait_for`` is the lockstep gate.

    ``reader_id`` is the lease slot this reader marks on every acquire (a
    worker's actor id): the slot names it on a reserve timeout and
    ``revoke`` clears it. ``device`` goes through ``resolve_device``: like
    every entry point of the port, the view puts the params on the card
    unless its caller asks for the CPU.
    """

    def __init__(self, handle: ShmParamHandle, reader_id: int,
                 device="cuda"):
        self.device = resolve_device(device)
        self._template = handle.template
        fields = [(s.shape, s.dtype) for _, s in tree_paths(handle.template)]
        offsets, _ = _layout(fields)
        self._shms = [_attach(n) for n in handle.names]
        self._bufs = [_views(s, fields, offsets) for s in self._shms]
        self._cond = handle.cond
        self._version = handle.version
        self._readers = handle.readers
        self._leases = handle.leases
        self._reader_id = reader_id

    def acquire(self) -> Tuple[List[np.ndarray], int]:
        with self._cond:
            v = int(self._version.value)
            self._readers[v % 2].value += 1
            self._leases[v % 2][self._reader_id] += 1
            return self._bufs[v % 2], v

    def release(self, version: int) -> None:
        with self._cond:
            idx = version % 2
            if self._leases[idx][self._reader_id] <= 0:
                return  # revoked under us — the slot already balanced
            self._leases[idx][self._reader_id] -= 1
            self._readers[idx].value -= 1
            assert self._readers[idx].value >= 0, "unbalanced release"
            self._cond.notify_all()

    def read_params(self) -> Tuple[Any, int]:
        """Newest params as a tree of tensors on ``device`` + their version
        (lease-bracketed: the copy is the entire critical section; a copy
        to a card from this pageable memory returns once it is done)."""
        views, version = self.acquire()
        try:
            leaves = iter([torch.from_numpy(v).to(self.device, copy=True)
                           for v in views])
        finally:
            self.release(version)
        return tree_map(lambda _: next(leaves), self._template), version

    def wait_for(self, version: int, timeout: Optional[float] = None) -> bool:
        with self._cond:
            return self._cond.wait_for(
                lambda: self._version.value >= version, timeout=timeout)

    def close(self) -> None:
        self._bufs = None
        for s in self._shms:
            _quiet_close(s)

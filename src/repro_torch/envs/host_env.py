"""Host-side environment worker pool — the paper's n_w workers, literally
(a port of ``repro.envs.host_env``).

The batched tensor environments of this package step all n_e instances in
a few tensor operations on the device, which is fast but only possible for
environments written as tensor programs. For *external* environments (a
C++ emulator like ALE, a network simulator, a real system), this module
reproduces the paper's §3 architecture exactly: ``n_e`` environment
instances are partitioned among ``n_w`` Python worker threads; the master
hands each worker its slice of the batched action vector; workers step
their environments in parallel and write observations/rewards into shared
numpy buffers.

This path is host-bound by construction — the paper's Fig. 2 "50% env
time" regime. ``ParallelRL`` drives it synchronously (host rollout, then
the update on the card) and ``PipelinedRL``'s host plane overlaps the env
stall with learning. Workers release the GIL while stepping external
processes, which is what makes the overlap real. ``HostEnvPool.shard``
splits the env axis into per-actor views for the multi-actor pipeline.

``device`` (default ``"cuda"``, resolved through ``resolve_device``: it
raises without a card) is where ``reset()`` and ``step()`` put their
tensors. Each is a synchronous copy of the shared buffers into a private
tensor, so it is complete when the call returns and the workers' next
writes cannot reach it. ``step_host`` returns the shared numpy buffers
themselves, for the pipeline's actors, which copy the rows into their own
staging sets.

**Picklable env-spec contract**: a live ``HostEnvPool`` holds running env
instances and a thread executor, neither of which crosses a process
boundary. ``HostEnvSpec`` is the picklable *recipe* for a pool: a
module-level constructor ``env_fn`` plus one positional-args tuple per env
instance, and the pool kwargs (``n_workers``/``obs_shape``/``obs_dtype``/
``device``, the last as a string). ``validate_picklable`` fails loudly on a
closure or lambda, ``build()`` makes the live pool and ``spec.shard(n)``
splits the env axis *as specs* — each builds a full, independent pool
over its slice (unlike ``HostEnvPool.shard``, whose shards borrow the
parent's workers).
"""
from __future__ import annotations

import concurrent.futures as cf
import pickle
from dataclasses import dataclass, replace as dataclass_replace
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["HostEnvPool", "HostEnvShard", "HostEnvSpec"]


class _EnvStepper:
    """Shared master/worker stepping over ``self.envs`` (paper §3 loop).

    Subclasses provide ``envs``, the output buffers ``_obs``/``_reward``/
    ``_done`` (leading axis ``n_envs``), the worker partition ``_slices``
    (index arrays into ``envs``), ``_executor()``, ``device`` and a
    ``_closed`` flag (``HostEnvShard`` mirrors its parent's, so closing a
    pool closes every shard view of it at once).
    """

    envs: List
    n_envs: int
    device: torch.device
    _closed: bool

    def _executor(self) -> cf.ThreadPoolExecutor:
        raise NotImplementedError

    def _check_open(self, op: str) -> None:
        """Loud guard: stepping a closed pool otherwise dies *inside* the
        executor with an opaque ``cannot schedule new futures after
        shutdown`` — indistinguishable from an env crash."""
        if self._closed:
            raise RuntimeError(
                f"{type(self).__name__}.{op}() on a closed env pool — the "
                "pool (or its parent) was close()d while this stepper was "
                "still in use; stop actors before closing their envs"
            )

    @property
    def obs_dtype(self):
        """Dtype of the observation buffers (what staging rings preallocate)."""
        return self._obs.dtype

    def _snapshot(self, a: np.ndarray) -> torch.Tensor:
        # torch.tensor always copies, and a copy to the card from pageable
        # memory is synchronous: the result never aliases the shared buffer
        return torch.tensor(a, device=self.device)

    def _submit_slices(self, fn, *args) -> None:
        futures = [self._executor().submit(fn, idxs, *args)
                   for idxs in self._slices]
        for f in futures:
            f.result()

    def _reset_slice(self, idxs: np.ndarray):
        for i in idxs:
            self._obs[i] = self.envs[i].reset()

    def reset(self) -> torch.Tensor:
        """Reset all envs, partitioned over the worker pool like ``step``;
        returns a private tensor of the observations on ``device``."""
        self._check_open("reset")
        self._submit_slices(self._reset_slice)
        return self._snapshot(self._obs)

    def _work(self, idxs: np.ndarray, actions: np.ndarray):
        for i in idxs:
            obs, r, done, _ = self.envs[i].step(int(actions[i]))
            if done:  # paper §5.1: restart on terminal
                obs = self.envs[i].reset()
            self._obs[i] = obs
            self._reward[i] = r
            self._done[i] = done

    def step_host(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Apply the master's batched actions; workers run in parallel.

        Returns views of the shared host buffers (valid until the next call)
        — the path the pipeline's actor threads use, which copy rows
        straight into their own trajectory staging sets.
        """
        self._check_open("step_host")
        self._submit_slices(self._work, np.asarray(actions))
        return self._obs, self._reward, self._done

    def step(self, actions) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``step_host`` with outputs copied onto ``device`` (snapshots —
        never aliases of the mutable shared buffers)."""
        obs, reward, done = self.step_host(actions)
        return self._snapshot(obs), self._snapshot(reward), self._snapshot(done)


class HostEnvPool(_EnvStepper):
    """Paper §3: n_e external env instances stepped by n_w workers.

    env_fns: callables creating gym-style envs with reset() -> obs and
    step(action) -> (obs, reward, done, info). ``device``: where
    ``reset``/``step`` put their tensors (the card unless the caller asks
    for the CPU).
    """

    def __init__(self, env_fns: Sequence[Callable], n_workers: int = 8,
                 obs_shape: Tuple[int, ...] = (), obs_dtype=np.float32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.envs = [fn() for fn in env_fns]
        self.n_envs = len(self.envs)
        self.n_workers = min(n_workers, self.n_envs)
        self.obs_shape = tuple(obs_shape)
        # shared output buffers (the paper's shared memory between master
        # and workers)
        self._obs = np.zeros((self.n_envs,) + self.obs_shape, obs_dtype)
        self._reward = np.zeros((self.n_envs,), np.float32)
        self._done = np.zeros((self.n_envs,), bool)
        self._pool = cf.ThreadPoolExecutor(max_workers=self.n_workers)
        self._slices = np.array_split(np.arange(self.n_envs), self.n_workers)
        self._closed = False

    def _executor(self) -> cf.ThreadPoolExecutor:
        return self._pool

    def shard(self, n: int) -> List["HostEnvShard"]:
        """Split the env axis into ``n`` equal per-actor shards.

        Each shard steps only its slice of the envs, with its own output
        buffers, on the *parent's* worker pool — total host concurrency stays
        bounded by ``n_workers`` no matter how many actors drive shards
        concurrently. The parent still owns the envs and the executor:
        close the parent, not the shards.
        """
        if self._closed:
            raise RuntimeError("shard() on a closed HostEnvPool")
        if n < 1 or self.n_envs % n:
            raise ValueError(
                f"cannot shard {self.n_envs} envs into {n} equal actor pools"
            )
        size = self.n_envs // n
        return [HostEnvShard(self, i * size, (i + 1) * size) for i in range(n)]

    def close(self):
        """Shut the worker pool down and close all envs. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=True)
        for env in self.envs:
            if hasattr(env, "close"):
                env.close()

    def __enter__(self) -> "HostEnvPool":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class HostEnvShard(_EnvStepper):
    """A per-actor slice [lo, hi) of a parent ``HostEnvPool``'s env axis.

    Same stepping API as the parent (``reset`` / ``step_host`` / ``step``)
    over ``(hi - lo)`` envs, sharing the parent's worker executor and
    device, so that N shards stepped from N actor threads still respect the
    pool's ``n_w`` worker bound (the paper's §3 resource model, divided
    among replicas).
    """

    def __init__(self, parent: HostEnvPool, lo: int, hi: int):
        self._parent = parent
        self.device = parent.device
        self.envs = parent.envs[lo:hi]
        self.n_envs = hi - lo
        self.obs_shape = parent.obs_shape
        self._obs = np.zeros((self.n_envs,) + self.obs_shape,
                             parent._obs.dtype)
        self._reward = np.zeros((self.n_envs,), np.float32)
        self._done = np.zeros((self.n_envs,), bool)
        # proportional share of the parent's workers (at least one)
        n_w = max(1, (parent.n_workers * self.n_envs) // parent.n_envs)
        self._slices = np.array_split(np.arange(self.n_envs),
                                      min(n_w, self.n_envs))

    @property
    def _closed(self) -> bool:
        # the parent owns envs + executor, so its close() closes every shard
        return self._parent._closed

    def _executor(self) -> cf.ThreadPoolExecutor:
        return self._parent._pool


# ---------------------------------------------------------------------------
# Picklable pool recipe
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HostEnvSpec:
    """Picklable recipe for a ``HostEnvPool`` (module docstring contract).

    ``env_fn`` is a module-level callable; env instance ``i`` is built as
    ``env_fn(*env_args[i])``. ``build()`` constructs the live pool (in
    whichever process calls it), ``shard(n)`` splits the env axis into ``n``
    equal per-actor specs, and ``validate_picklable()`` fails fast — with
    the offending payload named. ``device`` is a string (``"cuda"``,
    ``"cpu"``), so the spec pickles.
    """

    env_fn: Callable
    env_args: Tuple[Tuple[Any, ...], ...]
    n_workers: int = 8
    obs_shape: Tuple[int, ...] = ()
    obs_dtype: Any = np.float32
    device: str = "cuda"

    @property
    def n_envs(self) -> int:
        return len(self.env_args)

    def build(self) -> HostEnvPool:
        return HostEnvPool(
            [lambda a=args: self.env_fn(*a) for args in self.env_args],
            n_workers=self.n_workers,
            obs_shape=self.obs_shape,
            obs_dtype=self.obs_dtype,
            device=self.device,
        )

    def shard(self, n: int) -> List["HostEnvSpec"]:
        """Split the env axis into ``n`` equal per-actor specs.

        Unlike ``HostEnvPool.shard`` (views on one live pool sharing its
        executor), each spec builds a fully independent pool. Worker
        threads are divided proportionally so ``n`` pools keep the parent
        spec's total host concurrency budget."""
        if n < 1 or self.n_envs % n:
            raise ValueError(
                f"cannot shard {self.n_envs} envs into {n} equal actor pools"
            )
        size = self.n_envs // n
        n_w = max(1, self.n_workers // n)
        return [
            dataclass_replace(
                self, env_args=self.env_args[i * size:(i + 1) * size],
                n_workers=n_w,
            )
            for i in range(n)
        ]

    def validate_picklable(self) -> None:
        try:
            pickle.dumps(self)
        except Exception as e:
            raise ValueError(
                "HostEnvSpec must pickle (a process that rebuilds the pool "
                "receives it by pickle): use a module-level env_fn and plain "
                f"env_args, not closures/lambdas — pickling failed with: {e!r}"
            ) from e

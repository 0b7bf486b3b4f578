"""Request/response types for the serving plane.

A ``Request`` is the unit the admission queue carries: a host-side
(numpy) prompt plus the per-request RNG stream root (``seed``) that makes
its sampled tokens independent of whatever co-resides in the decode
batch. The scheduler mutates it in place through its lifecycle
(``QUEUED -> ACTIVE -> DONE | ERRORED``) and hands the same object back
from ``Scheduler.run()`` — there is no separate response type; the
filled-in fields (``tokens``, the timing stamps) *are* the response.

Timing stamps (``time.perf_counter`` seconds) support the serve bench's
p50/p99 latency: ``t_submit`` when the traffic source enqueued it,
``t_admit`` when the scheduler took it off the queue, ``t_first`` when
its prefill dispatched (first sampled token in flight), ``t_done`` at
retire/evict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

QUEUED = "queued"
ACTIVE = "active"
DONE = "done"
ERRORED = "errored"


@dataclass
class Request:
    """One generation request riding the admission queue."""

    rid: int
    prompt: np.ndarray  # (S,) int32 token ids
    max_new_tokens: int
    seed: int  # root of this request's RNG stream (one draw per (seed, t))
    status: str = QUEUED
    slot: Optional[int] = None  # decode-batch row while ACTIVE
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    tokens: Optional[np.ndarray] = None  # (n,) int32, set at retire/evict
    error: Optional[str] = None
    # deferred slot handoff (the ring's Rollout.release idiom): installed
    # at admission next to the allocate, invoked exactly once at retire
    _free: Optional[Callable[[], None]] = None
    # tokens sampled so far, counted host-side (completion is length-
    # based); the values stay in the engine's device-side ring log until
    # harvest at retire, so the decode hot path never touches device data
    n_live: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.shape[0] < 1:
            raise ValueError(
                f"request {self.rid}: prompt must be a non-empty 1-D int "
                f"array, got shape {self.prompt.shape}"
            )
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1, got "
                f"{self.max_new_tokens}"
            )

    @property
    def n_generated(self) -> int:
        """Tokens sampled so far (counted while ACTIVE, final after)."""
        if self.tokens is not None:
            return int(self.tokens.shape[0])
        return self.n_live

    @property
    def latency_s(self) -> float:
        """Submit-to-done latency (the bench's p50/p99 input)."""
        return self.t_done - self.t_submit

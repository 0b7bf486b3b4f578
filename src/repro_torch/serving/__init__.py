"""Serving plane of the port: continuous batching for policy inference.

* ``request``   — the ``Request`` unit the admission queue carries.
* ``slots``     — ``KVSlotCache``: lease discipline over cache rows.
* ``engine``    — ``DecodeEngine``: one fixed-width decode step.
* ``scheduler`` — continuous / lockstep admission over one engine.
* ``traffic``   — open-loop (Poisson or burst) request sources.
"""
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.request import ACTIVE, DONE, ERRORED, QUEUED, Request
from repro_torch.serving.scheduler import SERVE_CATEGORIES, Scheduler
from repro_torch.serving.slots import (KVSlotCache, SlotCacheClosed,
                                       SlotError, SlotsExhausted)
from repro_torch.serving.traffic import OpenLoopTraffic, make_requests

__all__ = [
    "ACTIVE", "DONE", "ERRORED", "QUEUED",
    "DecodeEngine", "KVSlotCache", "OpenLoopTraffic", "Request",
    "SERVE_CATEGORIES", "Scheduler", "SlotCacheClosed", "SlotError",
    "SlotsExhausted", "make_requests",
]

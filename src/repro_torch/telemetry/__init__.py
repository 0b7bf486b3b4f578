"""Telemetry of the port: span recording (``spans``), the per-run hub
(``hub.Telemetry``: emitter registry, counters, gauges, reports, the JSONL
heartbeat and the stall watchdog) and the Chrome trace export
(``trace``)."""
from repro_torch.telemetry.hub import ShippedTrack, Telemetry
from repro_torch.telemetry.spans import (
    CATEGORIES,
    COLLECT,
    LEARNER_UPDATE,
    LEASE,
    PUBLISH,
    QUEUE_GET_WAIT,
    QUEUE_PUT_WAIT,
    SpanEmitter,
)
from repro_torch.telemetry.trace import write_chrome_trace

__all__ = [
    "CATEGORIES",
    "COLLECT",
    "QUEUE_PUT_WAIT",
    "QUEUE_GET_WAIT",
    "LEASE",
    "PUBLISH",
    "LEARNER_UPDATE",
    "ShippedTrack",
    "SpanEmitter",
    "Telemetry",
    "write_chrome_trace",
]

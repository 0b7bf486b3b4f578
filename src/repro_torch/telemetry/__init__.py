"""Telemetry of the port: span recording. The hub, heartbeat and trace
export wait for ROADMAP.md Queue 1, item 13."""
from repro_torch.telemetry.spans import SpanEmitter

__all__ = ["SpanEmitter"]

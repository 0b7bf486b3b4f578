"""Minimal structured logging for the port (a copy of ``repro``'s).

Configuration is idempotent per process: the guard is "does the
``repro_torch`` root logger already have handlers", so a host application
that configured it itself is never double-handled. ``REPRO_LOG_LEVEL``
(e.g. ``DEBUG``, ``WARNING``, ``25``) overrides the default ``INFO``
level; an unrecognized value falls back to ``INFO`` with a warning.
"""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"
_ROOT = "repro_torch"
_level_applied = False


def _env_level() -> int:
    raw = os.environ.get("REPRO_LOG_LEVEL", "").strip()
    if not raw:
        return logging.INFO
    level = logging.getLevelName(raw.upper())
    if isinstance(level, int):
        return level
    if raw.isdigit():
        return int(raw)
    logging.getLogger(_ROOT).warning(
        "REPRO_LOG_LEVEL=%r is not a log level; using INFO", raw)
    return logging.INFO


def get_logger(name: str) -> logging.Logger:
    global _level_applied
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
    if not _level_applied:
        if root.level == logging.NOTSET or "REPRO_LOG_LEVEL" in os.environ:
            root.setLevel(_env_level())
        _level_applied = True
    return logging.getLogger(f"{_ROOT}.{name}")

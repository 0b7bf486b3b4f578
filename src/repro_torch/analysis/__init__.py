"""Correctness tooling for the pipeline's unchecked invariants (a port of
``repro.analysis``).

Three tools, one package:

* ``repro_torch.analysis.lint`` — stdlib-``ast`` static checks over the
  port's sources: lease acquire/release pairing under ``try/finally``,
  ``SpanEmitter`` begin/end-or-cancel balance, no reuse of donated
  buffers, no host syncs on ``# hot-path`` functions (torch's ``.cpu()``,
  ``.numpy()``, ``.item()``, ``.tolist()``, ``.synchronize()`` among
  them) and picklable ``HostEnvSpec`` construction.
  ``python -m repro_torch.analysis.lint src/repro_torch``.
* ``repro_torch.analysis.lockcheck`` — runtime lock-order detector: the
  pipeline's and the serving plane's ``Lock``/``Condition`` sites are
  built through ``make_lock``/``make_condition``, which return
  instrumented wrappers under ``REPRO_SANITIZE=locks``; they record
  per-thread acquisition stacks into one lock-order graph and flag cycles
  (potential deadlock) and wait-while-holding-a-foreign-lock hazards.
* ``repro_torch.analysis.sanitize`` — host-sync and in-place sanitizer:
  under ``REPRO_SANITIZE=transfers`` the learner's steady state and the
  device-plane collects run inside ``guard`` scopes, where a host sync
  that torch reports (``torch.cuda.set_sync_debug_mode``) raises on the
  guarded thread unless an ``allowed`` scope names it as an intended
  edge, and a probe checks that the update publishes into the reserved
  ping-pong buffer in place.

The sanitizers are **off by default and free when off**: the factories
hand back plain ``threading`` primitives and the guard scopes are no-op
context managers, so the hot paths are untouched unless ``REPRO_SANITIZE``
(comma-separated modes, read at call time) or ``enable_sanitizers()``
(the trainer's ``--sanitize`` flag) turns a mode on.
"""
from __future__ import annotations

import os
import sys
from typing import Set

SANITIZE_ENV = "REPRO_SANITIZE"
SANITIZE_MODES = ("locks", "transfers")

# modes forced on programmatically (the --sanitize flag, tests); unioned
# with the env var at every query, so either switch works mid-process
_forced: Set[str] = set()


def parse_modes(spec: str) -> Set[str]:
    """The modes of a comma-separated spec (``""`` gives none); raises
    ``ValueError`` naming any unknown one."""
    modes = {m.strip() for m in spec.split(",") if m.strip()}
    bad = modes - set(SANITIZE_MODES)
    if bad:
        raise ValueError(
            f"unknown sanitize mode(s) {sorted(bad)}: pick from "
            f"{SANITIZE_MODES} (comma-separated)"
        )
    return modes


def enable_sanitizers(spec) -> Set[str]:
    """Force sanitizer modes on for this process (``"locks,transfers"``
    or an iterable of mode names). Returns the modes enabled."""
    if isinstance(spec, str):
        modes = parse_modes(spec)
    else:
        modes = set()
        for m in spec:
            modes |= parse_modes(m)
    _forced.update(modes)
    return modes


def disable_sanitizers(spec=None) -> None:
    """Drop programmatically-forced modes (all of them when ``spec`` is
    None). The env var, if set, still applies. When the transfers mode
    goes off, the sync reporting a guard armed is disarmed too, so the
    rest of the process runs as it would without the sanitizer."""
    if spec is None:
        _forced.clear()
    else:
        _forced.difference_update(
            parse_modes(spec) if isinstance(spec, str) else set(spec))
    sanitize = sys.modules.get(__name__ + ".sanitize")
    if sanitize is not None and not sanitizer_enabled("transfers"):
        sanitize.disarm()


def sanitizer_enabled(mode: str) -> bool:
    """Is ``mode`` on — via ``REPRO_SANITIZE`` or ``enable_sanitizers``?
    Read at call time so tests and the launcher can flip it dynamically
    (objects built *before* the flip stay uninstrumented)."""
    if mode not in SANITIZE_MODES:
        raise ValueError(f"unknown sanitize mode {mode!r}")
    if mode in _forced:
        return True
    env = os.environ.get(SANITIZE_ENV, "")
    return mode in parse_modes(env) if env else False

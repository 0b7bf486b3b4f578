"""One run of one cell, from set-up to the result line.

The cell's traffic mix names its driver (``drivers/<driver>.py``), which
builds the program, drives its first steps, runs the window and checks
the first steps against the plain reference. This module times set-up and
the window, profiles one call after the window when traced, reads each
metric through its reader (``end_to_end/<metric>.py``,
``metrics/<metric>.py``), and assembles the line.
"""
from __future__ import annotations

import importlib
import math
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from portbench import counts, profiling, spec

RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")
BREAKDOWN_ROWS = 10


@dataclass
class Context:
    """What a metric's reader reads."""
    cell: spec.Cell
    device: torch.device
    setup_s: float
    window: object  # the driver's Measured: iterations, seconds, work, ...
    trace: Optional[profiling.Window]
    flops_per_iter: float
    peak_flops: float


def driver(cell: spec.Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def profile_call(drv, session) -> profiling.Window:
    """One call of the window's kind under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if session.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        measured = drv.stretch(session)
    return profiling.read_profile(prof, measured.iterations,
                                  measured.seconds)


def read_metrics(metrics: List[dict], ctx: Context) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = spec.reader(m["name"], m.get("kind", "metrics"))(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None,
             fault: Optional[str] = None) -> Tuple[dict, List[str]]:
    """-> (the result line as a dict, the check's lines for stderr)."""
    t0 = time.perf_counter() if t0 is None else t0
    drv = driver(cell)
    dev = torch.device(device)
    drv.set_precision(cell)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    session = drv.setup(cell, seed, dev, fault=fault)
    setup_s = time.perf_counter() - t0
    measured = drv.window(session, seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window = None
    if trace:
        window = profile_call(drv, session)
    observed = drv.release(session)
    nums = drv.check(cell, seed, dev, observed)
    ctx = Context(cell, dev, setup_s, measured, window, drv.flops_per_iter(cell),
                  counts.PEAK_FLOPS[cell.config["precision"]])
    metrics = (read_metrics(cell.per_layer, ctx) if trace else
               read_metrics([dict(m, kind="end_to_end")
                             for m in cell.end_to_end], ctx))
    if set(nums) != set(cell.limits):
        raise KeyError(f"numbers {sorted(nums)} against limits "
                       f"{sorted(cell.limits)}")
    correct = all(math.isfinite(v) and v <= cell.limits[k]
                  for k, v in nums.items())
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": cell.chips, "memory_peak_bytes": peak}
    if dev.type == "cuda":
        dev_info["power"] = power_limit()
    result = {"correct": correct, "attempted": measured.iterations,
              "failed": measured.failed, "metrics": metrics,
              "device": dev_info}
    if window is not None:
        dev_info["busy_s"] = window.busy_s
        dev_info["window_s"] = window.window_s
        result["breakdown"] = {
            "device_ops": window.top_ops(BREAKDOWN_ROWS),
            "idle_gaps": window.idle_gaps(BREAKDOWN_ROWS)}
    result["checks"] = {k: {"value": v, "limit": cell.limits[k]}
                        for k, v in nums.items()}
    lines = [f"check {k} {v!r} limit {cell.limits[k]!r}"
             for k, v in nums.items()]
    return result, lines


def schema_errors(result: dict) -> List[str]:
    """What keeps ``result`` from being a valid last line."""
    errs = [f"missing {k}" for k in RESULT_KEYS if k not in result]
    if errs:
        return errs
    if not isinstance(result["correct"], bool):
        errs.append("correct is not a bool")
    for k in ("attempted", "failed"):
        if not isinstance(result[k], int) or result[k] < 0:
            errs.append(f"{k} is not a count")
    for name, m in result["metrics"].items():
        if set(m) != {"value", "unit"} or not isinstance(
                m["value"], (int, float)) or not math.isfinite(m["value"]):
            errs.append(f"metric {name} is not a finite value with a unit")
    d = result["device"]
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        if k not in d:
            errs.append(f"device lacks {k}")
    if "breakdown" in result:
        for k in ("device_ops", "idle_gaps"):
            rows = result["breakdown"].get(k, [])
            if len(rows) > BREAKDOWN_ROWS or any(
                    len(r) != 2 or not isinstance(r[1], float) for r in rows):
                errs.append(f"breakdown {k} malformed")
    if list(result)[-1] != "checks":
        errs.append("the checks are not the last key")
    return errs

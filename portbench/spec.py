"""What a cell is made of, found by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells and metrics. A
cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json`` (which names the driver,
``drivers/<driver>.py``), the limits of its output check
``limits/<cell>.json``, and each metric a reader with a ``read(ctx)``
function, ``end_to_end/<metric>.py`` or ``metrics/<metric>.py``, all
beside this file; a metric ``<quantity>.<part>`` (``device_idle_pct.sync``)
without a file of its own takes its quantity's reader
(``metrics/device_idle_pct.py``). Adding a cell, a mix or a metric adds
files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json: {number: limit}; {} before they are set
    end_to_end: List[dict]  # the metrics this cell reports untraced
    per_layer: List[dict]  # ... and traced

    @property
    def job(self) -> dict:
        """The traffic mix with the configuration's action count."""
        return dict(self.traffic, num_actions=self.config["num_actions"])


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A per-layer metric is read in the cells its ``workloads`` lists or,
    without that key, in every cell that reports the end-to-end metric it
    moves (those that later cells add too)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported


def cell(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = benchmark() if bench is None else bench
    rows = [w for w in bench["workloads"] if w["name"] == name]
    if not rows:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = rows[0]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    limits = HERE / "limits" / f"{name}.json"
    return Cell(name=name, chips=w["chips"],
                config=load_json(HERE / "configs" / f"{w['config']}.json"),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=(load_json(limits) if limits.is_file() else {}),
                end_to_end=e2e, per_layer=layer)


def reader(metric: str, kind: str = "metrics") -> Callable:
    """``read(ctx)`` of ``<kind>/<metric>.py``, or else of its quantity's
    ``<kind>/<metric up to its last '.'>.py``: ``kind`` is ``metrics`` for
    a per-layer metric, ``end_to_end`` for an end-to-end one."""
    path = HERE / kind / f"{metric}.py"
    if not path.is_file() and "." in metric:
        path = HERE / kind / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

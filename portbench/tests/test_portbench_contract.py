"""``BENCHMARK.json`` against the rules it is held to, and every file a
cell is found by."""
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        for w in m.get("workloads", CELLS):
            assert w in CELLS
            assert "workloads" not in E2E[m["moves"]] or \
                w in E2E[m["moves"]]["workloads"]
        if m["name"].split(".")[0].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    c = spec.cell(cell)
    assert c.traffic["driver"]
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())
    reported = [m["name"] for m in c.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.end_to_end:
        assert spec.reader(m["name"], "end_to_end")
    for m in c.per_layer:
        assert spec.reader(m["name"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_hold_the_program_config(config):
    from repro_torch.configs import get_config

    assert config["file"] == f"portbench/configs/{config['name']}.json"
    assert config["reduced"] == []
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    f = spec.load_json(spec.ROOT / config["file"])
    arch = get_config(f["arch"])
    assert tuple(map(tuple, f["cnn_spec"])) == tuple(arch.cnn_spec)
    assert f["cnn_dense"] == arch.cnn_dense
    assert tuple(f["obs_shape"]) == tuple(arch.obs_shape)
    assert f["compute_dtype"] == arch.compute_dtype == f["precision"]


def test_a_metric_without_workloads_is_read_wherever_its_metric_moves():
    """A per-layer metric with no ``workloads`` key is read in every cell
    that reports the end-to-end metric it moves, later cells too."""
    extra = {"name": "launches_per_iter.pipelined", "unit": "launches/iter",
             "better": "lower", "source": "device_trace",
             "layer": "host dispatch", "moves": "pipelined_timesteps_per_s"}
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [extra])
    for name in CELLS:
        c = spec.cell(name, bench)
        reads = extra["name"] in {m["name"] for m in c.per_layer}
        assert reads is (extra["moves"] in {m["name"] for m in c.end_to_end})


@pytest.mark.parametrize("metric, kind, file", [
    ("device_idle_pct.sync", "metrics", "metrics/device_idle_pct.py"),
    ("launches_per_iter.pipelined", "metrics", "metrics/launches_per_iter.py"),
    ("timesteps_per_s", "end_to_end", "end_to_end/timesteps_per_s.py"),
])
def test_a_metric_part_takes_its_quantitys_reader(metric, kind, file):
    assert spec.reader(metric, kind).__code__.co_filename.endswith(file)

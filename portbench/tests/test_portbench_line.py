"""The result line's schema and the import guard."""
import copy

import pytest

from portbench import guard, harness

GOOD = {
    "correct": True, "attempted": 600, "failed": 0,
    "metrics": {"timesteps_per_s": {"value": 40008.9, "unit": "timesteps/s"},
                "setup_s": {"value": 9.5, "unit": "s"}},
    "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
               "count": 1, "memory_peak_bytes": 2_000_000_000},
    "checks": {"loss_gap": {"value": 1e-7, "limit": 1e-5}},
}


def test_good_line():
    assert harness.schema_errors(GOOD) == []
    traced = copy.deepcopy(GOOD)
    traced["device"].update(busy_s=0.3, window_s=0.8)
    traced["breakdown"] = {"device_ops": [["conv", 0.1]],
                           "idle_gaps": [["aten::item", 0.2]]}
    traced["checks"] = traced.pop("checks")
    assert harness.schema_errors(traced) == []


@pytest.mark.parametrize("breaks", [
    lambda r: r.pop("correct"),
    lambda r: r.update(correct="yes"),
    lambda r: r.update(attempted=-1),
    lambda r: r["metrics"]["setup_s"].update(value=float("nan")),
    lambda r: r["metrics"]["setup_s"].pop("unit"),
    lambda r: r["device"].pop("kind"),
    lambda r: r.update(checks=r.pop("checks"), extra=1),
    lambda r: r.update(breakdown={"device_ops": [["x", 1.0]] * 11}),
])
def test_broken_lines(breaks):
    r = copy.deepcopy(GOOD)
    breaks(r)
    assert harness.schema_errors(r)


@pytest.mark.parametrize("modules, found", [
    (["torch", "repro_torch", "repro_torch.core", "portbench.harness"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.framework"], ["repro"]),
    (["jax._src.api", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib"]),
    (["benchmarks.run", "benchmarks_extra"], ["benchmarks"]),
    (["jax_like", "reprolib", "flaxen"], []),
])
def test_guard_compares_whole_top_level_names(modules, found):
    assert guard.forbidden(modules) == found

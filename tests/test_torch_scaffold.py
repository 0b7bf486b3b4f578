"""The port stands alone: no JAX, no ``repro``, kernels from its sources.

* ``repro_torch`` (every module) and ``chip_smoke`` import in a fresh
  interpreter where ``jax`` and ``repro`` cannot be imported;
* no module under ``src/repro_torch``, not ``chip_smoke.py`` and no
  ``examples/*_torch.py`` names ``jax`` or ``repro`` in an import (AST
  scan);
* every kernel source carries its note and C entry point, is built, the
  build goes to an ignored directory, and ``chip_smoke.py`` refuses to run
  without a CUDA device, printing no result;
* the training, pipeline, MLA, SSM, agents and host env slices' modules
  are among those the pins above cover.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("*_torch.py")))


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_and_chip_smoke_import_with_jax_and_repro_blocked():
    mods = list(_modules())
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert all(sys.modules[m] is None for m in bad), bad\n"
            "print('ok', len(" + repr(mods) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (
            f"{path.relative_to(ROOT)} imports {name}")


def test_every_kernel_source_is_annotated_and_built_into_an_ignored_dir():
    from repro_torch.kernels import _build

    pallas = {"vtrace": "vtrace.py::vtrace_returns",  # source -> Pallas
              "mla_decode": "mla_decode.py::mla_decode_attention",
              "mla_decode_bf16": "mla_decode.py::mla_decode_attention",
              "ssd_scan_bf16": "ssd_scan.py::ssd_scan",
              "flash_attention_bf16": "flash_attention.py::flash_attention"}
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        fn = pallas.get(name, f"{name}.py::{name}")
        assert f"src/repro/kernels/{fn}_pallas" in src
        assert "What bounds it" in src and "What the design does" in src
        assert f'extern "C" int {name}_fwd(' in src
        assert "torch/extension.h" not in src  # plain C interface, fast nvcc
    assert _build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_every_source_is_built_and_the_training_slice_is_pinned():
    from repro_torch.kernels import _build

    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(
        _build.SOURCES)
    mods = set(_modules())
    for m in ("kernels.nstep_returns", "core.returns", "core.rollout",
              "core.framework", "core.agents.base", "core.agents.paac",
              "optim.optimizer", "optim.schedules", "configs.paac_cnn",
              "models.convnet", "envs.base", "envs.gridworld", "envs.catch",
              "envs.atari_like", "envs.wrappers", "launch.paper_atari",
              "utils.tree", "utils.bridge", "kernels.vtrace",
              "configs.base", "telemetry.hub", "telemetry.trace",
              "pipeline.actor", "pipeline.ring", "pipeline.learner",
              "pipeline.orchestrator", "kernels.mla_decode",
              "kernels.ssd_scan", "models.ssm", "configs.minicpm3_4b",
              "configs.mamba2_370m", "core.agents.dqn", "core.agents.replay",
              "core.agents.baselines", "core.agents.ppo", "core.evaluation",
              "envs.token_env", "envs.cartpole", "launch.train",
              "envs.host_env", "envs.pyemu", "pipeline.queue"):
        assert f"repro_torch.{m}" in mods, m


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:  # alone, without the rest of the repository
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={k: v for k, v in os.environ.items()
                                  if k != "PYTHONPATH"})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

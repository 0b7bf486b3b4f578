"""The port's serving example (``examples/serve_batch_torch.py``) on the
CPU: it forwards to ``repro_torch.launch.serve.main`` with ``--reduced``
added, as the reference's ``examples/serve_batch.py`` forwards to its
launcher, and leaves ``sys.argv`` alone."""
import importlib.util
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / \
    "serve_batch_torch.py"


def load():
    spec = importlib.util.spec_from_file_location("serve_batch_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen2-7b", "--batch", "2", "--prompt-len", "8", "--gen", "4"],
    ["--arch", "mamba2-370m", "--continuous", "--requests", "3", "--slots",
     "2", "--prompt-len", "8", "--gen", "3"],
], ids=["lockstep", "continuous"])
def test_serve_batch_example_runs_reduced_on_the_cpu(argv, monkeypatch):
    mod = load()
    seen = []
    real = mod.main
    monkeypatch.setattr(mod, "main", lambda a: seen.append(a) or real(a))
    before = list(sys.argv)
    out = mod.run(argv + ["--device", "cpu"])
    assert sys.argv == before
    assert seen and seen[0][-1] == "--reduced"
    assert isinstance(out, dict) and out

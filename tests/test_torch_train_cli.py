"""The port's trainer, ``repro_torch.launch.train``, against the reference's
``repro.launch.train`` (CPU, small shapes), and the port's two examples.

* The parser has every flag of the reference with the reference's
  defaults, except ``--arch``'s (``paac_vector`` until the token archs'
  training pass is ported) and the added ``--device``.
* Every ``SystemExit`` of the reference's flag validation comes in the
  reference's order with the reference's text: each case below goes
  through both ``run_rl``s, several with more than one fault at once.
* Each flag the port does not run raises ``NotImplementedError`` naming
  its ROADMAP Queue 1 item.
* ``--device cpu`` runs the three ported legs (PAAC synchronous,
  ``--pipeline`` and ``--algo dqn``) on the reference's ``TokenEnv``
  setting; without a card and without ``--device cpu`` the trainer raises.
* ``examples/quickstart_torch.py`` and ``examples/compare_baselines_torch.py``
  run at a tiny size on the CPU.
"""
import importlib.util
import json
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import repro.launch.train as ref_train  # noqa: E402
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.envs import TokenEnv  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--n-envs", "4", "--t-max", "3", "--iterations",
        "4"]


def test_flags_and_defaults_are_the_references(monkeypatch):
    captured = {}
    monkeypatch.setattr(ref_train, "run_rl", lambda a: captured.update(vars(a)))
    monkeypatch.setattr(sys, "argv", ["train"])
    ref_train.main()
    port = vars(train.build_parser().parse_args([]))
    assert port.pop("device") == "cuda"
    assert port.pop("arch") == "paac_vector"
    assert captured.pop("arch") == "mamba2-370m"
    assert port == captured
    assert train.ASSIGNED_ARCHS == ASSIGNED_ARCHS


SYSTEM_EXITS = [
    ["--actor-backend", "process"],
    ["--actor-backend", "process", "--mesh", "2", "--trace", "t.json"],
    ["--mesh", "2"],
    ["--mesh", "2", "--sanitize", "locks"],
    ["--trace", "t.json"],
    ["--metrics-jsonl", "m.jsonl", "--replay"],
    ["--stall-timeout", "5"],
    ["--sanitize", "locks"],
    ["--sanitize", "locks", "--replay", "--elastic"],
    ["--replay"],
    ["--replay", "--prioritized"],
    ["--prioritized"],
    ["--pipeline", "--prioritized", "--algo", "dqn"],
    ["--pipeline", "--algo", "dqn"],
    ["--pipeline", "--algo", "dqn", "--host-env"],
    ["--pipeline", "--replay", "--host-env"],
    ["--pipeline", "--replay", "--actor-backend", "process"],
    ["--elastic"],
    ["--fault-kill", "0:1"],
    ["--fault-stall-learner", "1:0.5", "--checkpoint-every", "2"],
    ["--checkpoint-every", "2"],
    ["--resume", "--checkpoint-dir", "ck"],
    ["--pipeline", "--checkpoint-every", "2"],
    ["--pipeline", "--resume", "--sanitize", "locks"],
]


@pytest.fixture(scope="module")
def reference_exits():
    """Each case's ``SystemExit`` text from the reference's ``run_rl``."""
    texts = []
    for argv in SYSTEM_EXITS:
        with pytest.raises(SystemExit) as e:
            ref_train.run_rl(train.build_parser().parse_args(argv))
        texts.append(str(e.value))
    return texts


@pytest.mark.parametrize("i", range(len(SYSTEM_EXITS)),
                         ids=[" ".join(a) for a in SYSTEM_EXITS])
def test_system_exits_come_in_the_references_order_with_its_text(
        reference_exits, i):
    with pytest.raises(SystemExit) as e:
        train.main(SYSTEM_EXITS[i] + ["--device", "cpu"])
    assert str(e.value) == reference_exits[i]


def test_every_reference_exit_is_among_the_cases(reference_exits):
    assert len(set(reference_exits)) == 10


UNPORTED = [
    (["--arch", "qwen2-7b"], "item 11"),
    (["--arch", "mamba2-370m", "--reduced"], "item 11"),
    (["--mode", "synthetic"], "item 11"),
    (["--host-env"], "item 8"),
    (["--pipeline", "--rollout-plane", "host"], "item 8"),
    (["--pipeline", "--actor-backend", "process"], "item 10"),
    (["--pipeline", "--replay"], "item 10"),
    (["--pipeline", "--algo", "dqn", "--replay"], "item 10"),
    (["--pipeline", "--elastic"], "item 10"),
    (["--pipeline", "--fault-kill", "0:1"], "item 10"),
    (["--pipeline", "--fault-stall-learner", "1:0.5"], "item 10"),
    (["--checkpoint", "ck.npz"], "item 10"),
    (["--pipeline", "--checkpoint-dir", "ck", "--checkpoint-every", "2"],
     "item 10"),
    (["--pipeline", "--checkpoint-dir", "ck", "--resume"], "item 10"),
    (["--pipeline", "--sanitize", "locks"], "item 13"),
    (["--pipeline", "--metrics-jsonl", "m.jsonl"], "item 13"),
    (["--pipeline", "--stall-timeout", "5"], "item 13"),
    (["--pipeline", "--mesh", "2"], "item 14"),
    (["--pipeline", "--rollout-plane", "mesh"], "item 14"),
]


@pytest.mark.parametrize("argv,item", UNPORTED,
                         ids=[" ".join(a) for a, _ in UNPORTED])
def test_what_is_not_ported_raises_naming_its_item(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        train.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("leg", [[], ["--pipeline"], ["--algo", "dqn"]],
                         ids=["paac", "pipeline", "dqn"])
def test_the_ported_legs_run_on_the_cpu(leg):
    rl, results = train.run_rl(train.build_parser().parse_args(TINY + leg))
    assert isinstance(rl.env, TokenEnv)
    assert (rl.env.vocab, rl.env.ctx, rl.env.k, rl.env.horizon) == (
        64, 32, 2, 64)
    assert rl.agent.cfg.obs_shape == (32,) and rl.agent.cfg.num_actions == 64
    if leg != ["--pipeline"]:
        assert rl.obs.dtype == torch.int32  # the raw token ids
    (res,) = results
    assert res.steps == 4 * 4 * 3
    assert all(math.isfinite(v) for v in res.mean_metrics.values())
    if leg == ["--pipeline"]:
        assert "staleness" in res.mean_metrics
    if leg == ["--algo", "dqn"]:
        assert rl.agent_state["replay"]["size"] == 4 * 4 * 3


def test_epochs_and_the_pipeline_trace(tmp_path):
    path = tmp_path / "trace.json"
    results = train.main(TINY + ["--epochs", "2", "--pipeline", "--trace",
                                 str(path), "--num-actors", "2"])
    assert [r.steps for r in results] == [4 * 2 * 3, 8 * 2 * 3]
    events = json.loads(path.read_text())["traceEvents"]
    assert {"collect", "learner.update"} <= {e["name"] for e in events
                                             if e["ph"] == "X"}


def test_the_trainer_raises_without_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--iterations", "1", "--n-envs", "2"])


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_on_the_cpu(capsys):
    part1, sync, ring = _example("quickstart_torch").main(
        ["--device", "cpu", "--n-envs", "4", "--epochs", "1", "--iters", "2",
         "--lock-iters", "3"])
    assert part1.steps == 2 * 4 * 5 and sync.steps == ring.steps == 3 * 4 * 5
    out = capsys.readouterr().out
    assert "bit for bit" in out and "item 8" in out and "item 14" in out


def test_compare_baselines_runs_on_the_cpu(capsys):
    scores = _example("compare_baselines_torch").main(
        ["--device", "cpu", "--n-envs", "4", "--iters", "2",
         "--final-iters", "1"])
    assert set(scores) == {"paac", "a3c_sim_stale_grad",
                           "ga3c_sim_policy_lag", "dqn"}
    assert all(math.isfinite(v) for v in scores.values())
    assert "higher is better" in capsys.readouterr().out

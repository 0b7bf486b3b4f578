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
  setting, the ``--host-env`` legs (synchronous and ``--pipeline``, with
  the reference's pool recipe), ``--pipeline --actor-backend process``,
  ``--pipeline --replay`` (uniform and prioritized) and ``--pipeline
  --algo dqn --replay``, ``--pipeline --rollout-plane host`` on the
  TokenEnv, and ``--metrics-jsonl`` with ``--stall-timeout``; without a
  card and without ``--device cpu`` the trainer raises.
* ``examples/quickstart_torch.py`` (its device and host legs bitwise equal
  to the synchronous run) and ``examples/compare_baselines_torch.py`` run
  at a tiny size on the CPU.
"""
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
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
    ["--arch", "qwen2-7b", "--host-env"],
    ["--arch", "mamba2-370m", "--pipeline", "--host-env"],
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
    # eleven exits; the vector/cnn one names the arch, so two of its texts
    assert len(set(reference_exits)) == 12


UNPORTED = [
    (["--arch", "qwen2-7b"], "item 11"),
    (["--arch", "mamba2-370m", "--reduced"], "item 11"),
    (["--mode", "synthetic"], "item 11"),
    (["--pipeline", "--elastic"], "item 10"),
    (["--pipeline", "--fault-kill", "0:1"], "item 10"),
    (["--pipeline", "--fault-stall-learner", "1:0.5"], "item 10"),
    (["--checkpoint", "ck.npz"], "item 10"),
    (["--pipeline", "--checkpoint-dir", "ck", "--checkpoint-every", "2"],
     "item 10"),
    (["--pipeline", "--checkpoint-dir", "ck", "--resume"], "item 10"),
    (["--pipeline", "--sanitize", "locks"], "item 13"),
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


@pytest.mark.parametrize("leg", [[], ["--pipeline"],
                                 ["--pipeline", "--num-actors", "2"]],
                         ids=["sync", "pipeline", "pipeline-2-actors"])
def test_the_host_env_legs_run_on_the_cpu(leg, monkeypatch):
    """``--host-env``: the reference's recipe, py_bound_spec(n_envs,
    obs_dim=16, spin, n_workers=min(8, n_envs)), 3 actions; the sync leg
    builds the pool, --pipeline hands over the spec; either way the pool
    is closed at the end."""
    from repro.envs import py_bound_spec as ref_spec
    from repro_torch.envs import HostEnvPool

    built, specs = [], []
    real_init, real_spec = HostEnvPool.__init__, train.py_bound_spec

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(HostEnvPool, "__init__", init)
    monkeypatch.setattr(train, "py_bound_spec",
                        lambda *a, **kw: specs.append(real_spec(*a, **kw))
                        or specs[-1])
    rl, results = train.run_rl(train.build_parser().parse_args(
        TINY + ["--host-env", "--env-spin", "20"] + leg))
    (spec,), (pool,) = specs, built
    want = ref_spec(4, obs_dim=16, spin=20, n_workers=4)
    assert (spec.env_fn.__name__, spec.env_args, spec.n_workers,
            spec.obs_shape, spec.device) == (
        want.env_fn.__name__, want.env_args, want.n_workers,
        want.obs_shape, "cpu")
    assert [e.spin for e in pool.envs] == [20] * 4
    assert pool._closed
    assert rl.agent.cfg.obs_shape == (16,) and rl.agent.cfg.num_actions == 3
    (res,) = results
    assert res.steps == 4 * 4 * 3 // (2 if "2" in leg else 1)
    assert all(math.isfinite(v) for v in res.mean_metrics.values())
    if leg:
        assert rl._plane == "host"


@pytest.mark.parametrize("leg", [
    ["--pipeline", "--actor-backend", "process", "--num-actors", "2"],
    ["--pipeline", "--replay", "--replay-capacity", "4"],
    ["--pipeline", "--replay", "--replay-batch", "2", "--prioritized"],
    ["--pipeline", "--algo", "dqn", "--replay", "--num-actors", "2"],
], ids=["process", "replay", "replay-prioritized", "dqn-replay"])
def test_the_process_and_replay_legs_run_on_the_cpu(leg):
    """``--actor-backend process`` implies the reference's host-env recipe
    and runs spawned workers, which ``run_rl`` reaps; ``--replay`` runs
    the sampled ReplayRing on the TokenEnv, PAAC or DQN."""
    rl, (res,) = train.run_rl(train.build_parser().parse_args(
        TINY + ["--env-spin", "20"] + leg))
    cfg = rl.pipeline
    n_actors = 2 if "--num-actors" in leg else 1
    assert cfg.actor_backend == ("process" if "process" in leg
                                 else "thread")
    assert cfg.replay_plane == ("--replay" in leg)
    assert cfg.prioritized == ("--prioritized" in leg)
    assert cfg.replay_batch == (2 if "--replay-batch" in leg else 1)
    assert res.steps == 4 * 4 * 3 // n_actors
    assert all(math.isfinite(v) for v in res.mean_metrics.values())
    if "process" in leg:
        assert rl._plane == "host" and rl._process_plane is None  # closed
        assert [s.n_envs for s in rl._proc_specs] == [2, 2]
        assert rl.agent.cfg.obs_shape == (16,)
    else:
        assert isinstance(rl.env, TokenEnv) and rl._plane == "device"


def test_the_forced_host_plane_and_the_observers_run_on_the_cpu(tmp_path):
    hb = tmp_path / "hb.jsonl"
    rl, (res,) = train.run_rl(train.build_parser().parse_args(
        TINY + ["--pipeline", "--rollout-plane", "host", "--metrics-jsonl",
                str(hb), "--stall-timeout", "30"]))
    assert isinstance(rl.env, TokenEnv) and rl._plane == "host"
    assert rl.pipeline.metrics_jsonl == str(hb)
    assert rl.pipeline.stall_timeout_s == 30.0
    assert res.steps == 4 * 4 * 3
    lines = [json.loads(x) for x in hb.read_text().splitlines()]
    assert lines and lines[-1]["steps"] == res.steps


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
    part1, sync, ring, host = _example("quickstart_torch").main(
        ["--device", "cpu", "--n-envs", "4", "--epochs", "1", "--iters", "2",
         "--lock-iters", "3"])
    assert part1.steps == 2 * 4 * 5
    assert sync.steps == ring.steps == host.steps == 3 * 4 * 5
    assert host.mean_metrics["loss"] == sync.mean_metrics["loss"]
    out = capsys.readouterr().out
    assert "bit for bit" in out and "item 14" in out and "item 8" not in out
    assert "      host: reward/iter=" in out


def test_compare_baselines_runs_on_the_cpu(capsys):
    scores = _example("compare_baselines_torch").main(
        ["--device", "cpu", "--n-envs", "4", "--iters", "2",
         "--final-iters", "1"])
    assert set(scores) == {"paac", "a3c_sim_stale_grad",
                           "ga3c_sim_policy_lag", "dqn"}
    assert all(math.isfinite(v) for v in scores.values())
    assert "higher is better" in capsys.readouterr().out

"""The port's analysis plane (``repro_torch.analysis``) on the CPU: the
linter against its own fixtures and against the reference's linter, the
lock-order detector as ``tests/test_analysis.py`` pins the reference's,
the host-sync sanitizer's semantics (driven through its warning hook,
since a CPU tensor never syncs with a card), the in-place probe, a
sanitized ``PipelinedRL`` run, the trainer's ``--sanitize`` and the
serving CLI's ``--trace``/``--metrics-jsonl``.

* Each lint rule fires on its own broken fixture in
  ``tests/fixtures/torch_lint/`` — one for each host sync that
  ``hot-path-sync`` learns from torch — and the clean fixture, the
  suppression comment and the CLI over ``src/repro_torch`` are quiet.
  On the reference's fixtures (``tests/fixtures/lint/``) both linters
  give the same findings, rule and line.
* The ten lock sites are plain ``threading``/``multiprocessing``
  primitives with the sanitizer off and named wrappers with it on.
* A guard refuses a sync reported on its own thread, an ``allowed`` edge
  absorbs one, and a sync on another thread passes, at the same time.
* Under ``locks,transfers`` a pipelined run on ``GridWorld`` guards its
  steady state, probes every update, attaches a clean ``lockcheck``
  report, and ends bitwise where the unsanitized run ends; a stray sync
  in a guarded learner step raises on the learner, while an actor's
  read-back on the host plane passes.
"""
import json
import multiprocessing as mp
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import repro.launch.train as ref_train  # noqa: E402
from repro.analysis import lint as ref_lint  # noqa: E402
from repro_torch.analysis import (disable_sanitizers,  # noqa: E402
                                  enable_sanitizers, parse_modes,
                                  sanitizer_enabled)
from repro_torch.analysis import lint as rlint  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.analysis.lockcheck import (SanitizedCondition,  # noqa: E402
                                            SanitizedLock, make_condition,
                                            make_lock, monitor)
from repro_torch.configs import PipelineConfig, get_config  # noqa: E402
from repro_torch.core.agents import PAACAgent, PAACConfig  # noqa: E402
from repro_torch.envs import GridWorld, py_bound_spec  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.optim import constant  # noqa: E402
from repro_torch.pipeline import PipelinedRL  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "torch_lint"
REF_FIXTURES = REPO / "tests" / "fixtures" / "lint"
SYNC = sanitize.SYNC_MESSAGE + " (Triggered internally at CUDAFunctions.cpp)"
INF = float("inf")


@pytest.fixture(autouse=True)
def _sanitizer_hygiene():
    """Every test starts and ends with sanitizers off and state clean."""
    disable_sanitizers()
    monitor().reset()
    sanitize.reset_stats()
    yield
    disable_sanitizers()
    monitor().reset()
    sanitize.reset_stats()


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------

SYNC_FORMS = ["item", "tolist", "cpu", "numpy", "cuda_synchronize",
              "stream_synchronize", "event_synchronize", "float", "int",
              "bool"]
RULE_FIXTURES = [("bad_lease.py", "lease-pairing"),
                 ("bad_slot_lease.py", "lease-pairing"),
                 ("bad_span.py", "span-pairing"),
                 ("bad_donated.py", "donated-reuse"),
                 ("bad_hostenv.py", "hostenv-picklable")] + [
    (f"bad_hotpath_{form}.py", "hot-path-sync") for form in SYNC_FORMS]


@pytest.mark.parametrize("fixture,rule", RULE_FIXTURES,
                         ids=[f for f, _ in RULE_FIXTURES])
def test_each_rule_fires_on_its_fixture(fixture, rule):
    path = FIXTURES / fixture
    findings = rlint.lint_paths([str(path)])
    assert {f.rule for f in findings} == {rule}
    if rule == "hot-path-sync":
        # exactly the line the fixture marks, nothing else
        marked = [i for i, line in enumerate(path.read_text().splitlines(), 1)
                  if line.rstrip().endswith("# host sync")]
        assert [f.line for f in findings] == marked


def test_the_torch_syncs_are_what_the_reference_linter_misses():
    """The forms the port adds: the reference finds none of them."""
    added = {"cpu", "numpy", "cuda_synchronize", "stream_synchronize",
             "event_synchronize"}
    for form in SYNC_FORMS:
        path = str(FIXTURES / f"bad_hotpath_{form}.py")
        assert bool(ref_lint.lint_paths([path])) == (form not in added), form


def test_clean_fixture_has_no_findings():
    assert rlint.lint_paths([str(FIXTURES / "clean.py")]) == []


def test_suppression_comment_silences_named_rule():
    src = (FIXTURES / "bad_hotpath_cpu.py").read_text()
    silenced = src.replace("# host sync",
                           "# repro-lint: disable=hot-path-sync")
    assert silenced != src
    assert rlint.lint_source(silenced, "x.py") == []
    other = src.replace("# host sync", "# repro-lint: disable=span-pairing")
    assert [f.rule for f in rlint.lint_source(other, "x.py")] == [
        "hot-path-sync"]


@pytest.mark.parametrize("fixture", sorted(p.name for p in
                                           REF_FIXTURES.glob("*.py")))
def test_parity_with_the_reference_linter_on_its_fixtures(fixture):
    path = str(REF_FIXTURES / fixture)
    mine = {(f.rule, f.line) for f in rlint.lint_paths([path])}
    theirs = {(f.rule, f.line) for f in ref_lint.lint_paths([path])}
    assert mine == theirs


@pytest.mark.parametrize("path,qualname", [
    ("pipeline/actor.py", "ActorBase._put"),
    ("pipeline/ring.py", "DeviceTrajectoryRing.put"),
    ("pipeline/ring.py", "DeviceTrajectoryRing.get"),
    ("pipeline/replay_ring.py", "ReplayRing.put"),
    ("pipeline/queue.py", "TrajectoryQueue.put"),
    ("serving/scheduler.py", "Scheduler._step"),
    ("serving/engine.py", "DecodeEngine.step"),
])
def test_the_hot_paths_carry_their_marker(path, qualname):
    src = (REPO / "src" / "repro_torch" / path).read_text()
    fl = rlint._FileLint(path, src)
    (func,) = [f for f, q, _ in fl.functions if q == qualname]
    assert fl._is_hot(func, qualname)


def test_cli_clean_on_the_port_and_nonzero_on_fixtures():
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin:/usr/local/bin"}

    def lint(*paths):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.lint", *paths],
            cwd=REPO, env=env, capture_output=True, text=True)

    clean = lint("src/repro_torch")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    bad = sorted(FIXTURES.glob("bad_*.py"))
    broken = lint(*map(str, bad))
    assert broken.returncode == 1
    for fixture in bad:
        assert fixture.name in broken.stdout
    assert lint("no/such/file.txt").returncode == 2
    # in-process: each broken fixture on its own
    for fixture in bad:
        assert rlint.main([str(fixture)]) == 1, fixture.name


# ---------------------------------------------------------------------------
# the lock-order detector (tests/test_analysis.py's cases, ported)
# ---------------------------------------------------------------------------


def test_factories_return_plain_primitives_when_off():
    assert not sanitizer_enabled("locks")
    assert not isinstance(make_lock("x"), SanitizedLock)
    assert not isinstance(make_condition("y"), SanitizedCondition)


def test_factories_return_wrappers_when_on():
    enable_sanitizers("locks")
    assert isinstance(make_lock("x"), SanitizedLock)
    assert isinstance(make_condition("y"), SanitizedCondition)


def test_lock_inversion_is_flagged_as_cycle():
    enable_sanitizers("locks")
    a, b = SanitizedLock("testA"), SanitizedLock("testB")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    rep = monitor().report()
    assert [c for c in rep["cycles"] if set(c) == {"testA", "testB"}]
    edges = {(e["from"], e["to"]) for e in rep["edges"]}
    assert ("testA", "testB") in edges and ("testB", "testA") in edges


def test_consistent_order_is_not_a_cycle():
    enable_sanitizers("locks")
    a, b = SanitizedLock("testA"), SanitizedLock("testB")
    for _ in range(3):
        with a:
            with b:
                pass
    assert monitor().cycles() == []


def test_distinct_instances_of_same_site_nesting_is_a_self_cycle():
    enable_sanitizers("locks")
    l1, l2 = SanitizedLock("same.site"), SanitizedLock("same.site")
    with l1:
        with l2:
            pass
    assert [c for c in monitor().cycles() if set(c) == {"same.site"}]


def test_wait_while_holding_foreign_lock_is_a_hazard():
    enable_sanitizers("locks")
    outer = SanitizedLock("outer.lock")
    cond = SanitizedCondition("inner.cond")
    with outer:
        with cond:
            cond.wait(timeout=0.01)
    hazards = monitor().report()["hazards"]
    assert [h for h in hazards
            if h["waiting_on"] == "inner.cond"
            and "outer.lock" in h["holding"]]
    monitor().reset()
    with cond:
        cond.wait(timeout=0.01)
    assert monitor().report()["hazards"] == []


def test_cross_thread_edges_merge_into_one_graph():
    enable_sanitizers("locks")
    a, b = SanitizedLock("testA"), SanitizedLock("testB")

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    for fn in (t1, t2):
        th = threading.Thread(target=fn)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    assert [c for c in monitor().cycles() if set(c) == {"testA", "testB"}]


def _sites():
    """The ten lock sites, each built fresh: (site name, primitive)."""
    from repro_torch.pipeline.actor import (ActorThread, HostStagingRing,
                                            PingPongParamSlot)
    from repro_torch.pipeline.queue import TrajectoryQueue
    from repro_torch.pipeline.replay_ring import ReplayRing
    from repro_torch.pipeline.ring import DeviceTrajectoryRing
    from repro_torch.pipeline.shm import ShmParamSlot
    from repro_torch.pipeline.supervisor import ActorSupervisor, QuotaLedger
    from repro_torch.serving.slots import KVSlotCache

    params = {"w": torch.ones(3)}
    slot = PingPongParamSlot(params)
    q = TrajectoryQueue(2)
    ledger = QuotaLedger(4)
    shm = ShmParamSlot(params, mp.get_context("spawn"))
    try:
        return [
            ("queue.cond", q._cond),
            ("ring.cond", DeviceTrajectoryRing(2, device="cpu")._cond),
            ("param_slot.cond", slot._cond),
            ("staging_ring.cond", HostStagingRing(2, 2, 2, (3,))._cond),
            ("actor.state", ActorThread(None, q, slot, None, 1)._state_lock),
            ("shm.param_slot", shm._cond),
            ("replay_ring.cond", ReplayRing(device="cpu")._cond),
            ("quota_ledger.cond", ledger._cond),
            ("supervisor.lock", ActorSupervisor(q, ledger, None)._lock),
            ("slots.cond", KVSlotCache(2)._cond),
        ]
    finally:
        shm.close()
        shm.unlink()


def test_the_ten_sites_are_plain_when_off_and_named_when_on():
    from multiprocessing.synchronize import Condition as MpCondition

    plain = {"actor.state": type(threading.Lock()),
             "supervisor.lock": type(threading.Lock()),
             "shm.param_slot": MpCondition}
    off = _sites()
    assert len(off) == 10
    for name, prim in off:
        assert type(prim) is plain.get(name, threading.Condition), name
    enable_sanitizers("locks")
    on = _sites()
    assert [n for n, _ in on] == [n for n, _ in off]
    for name, prim in on:
        want = SanitizedLock if name in ("actor.state", "supervisor.lock") \
            else SanitizedCondition
        assert type(prim) is want and prim._name == name, name
    _, shm_cond = on[5]
    assert type(shm_cond._inner) is MpCondition  # rides the mp condition


# ---------------------------------------------------------------------------
# the host-sync sanitizer and the in-place probe
# ---------------------------------------------------------------------------


def test_mode_parser_and_env_var(monkeypatch):
    assert parse_modes("") == set()
    assert parse_modes(" locks , transfers ") == {"locks", "transfers"}
    with pytest.raises(ValueError, match="bogus"):
        enable_sanitizers("locks,bogus")
    assert not sanitizer_enabled("transfers")
    monkeypatch.setenv("REPRO_SANITIZE", "transfers")
    assert sanitizer_enabled("transfers") and not sanitizer_enabled("locks")
    with pytest.raises(ValueError):
        sanitizer_enabled("bogus")


def test_guard_is_noop_when_off():
    with pytest.warns(UserWarning, match="synchronizing"):
        with sanitize.guard():
            warnings.warn(SYNC, UserWarning)  # would raise if guarded
    assert sanitize.stats == {"guarded": 0, "allowed": 0, "probed": 0}
    assert warnings.showwarning is not sanitize._showwarning


def test_sync_inside_guard_raises_and_allowed_absorbs_it():
    enable_sanitizers("transfers")
    with pytest.raises(sanitize.HostSyncViolation, match="[Dd]isallow"):
        with sanitize.guard():
            warnings.warn(SYNC, UserWarning)
    assert sanitize.stats["guarded"] == 1
    with sanitize.guard():
        with sanitize.allowed("test edge"):
            warnings.warn(SYNC, UserWarning)
            warnings.warn(SYNC, UserWarning)  # "always": not deduplicated
    with sanitize.guard(active=False):  # the warm-up call: exempt
        warnings.warn(SYNC, UserWarning)
    assert sanitize.stats == {"guarded": 2, "allowed": 1, "probed": 0}
    assert sanitize.edge_stats == {"test edge": [1, 2]}
    assert sanitize.host_syncs == {"unguarded": 1, "allowed": 2,
                                   "refused": 1}
    # any other warning goes on to the usual handling
    with pytest.warns(UserWarning, match="something else"):
        with sanitize.guard():
            warnings.warn("something else", UserWarning)
    disable_sanitizers()
    assert warnings.showwarning is not sanitize._showwarning


def test_the_guard_is_per_thread():
    """A guarded thread's sync raises while another thread's sync, at the
    same moment, passes: the mode is process-wide, the verdict is not."""
    enable_sanitizers("transfers")
    ready = threading.Barrier(2, timeout=10)
    out = {}

    def guarded():
        with sanitize.guard():
            ready.wait()
            try:
                warnings.warn(SYNC, UserWarning)
            except sanitize.HostSyncViolation as e:
                out["guarded"] = e
            ready.wait()

    def reader():
        ready.wait()
        for _ in range(5):
            warnings.warn(SYNC, UserWarning)  # the actor's read-back
        out["reader"] = "passed"
        ready.wait()

    threads = [threading.Thread(target=guarded, name="learner"),
               threading.Thread(target=reader, name="actor")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert "'learner'" in str(out["guarded"]) and out["reader"] == "passed"
    assert sanitize.host_syncs == {"unguarded": 5, "allowed": 0,
                                   "refused": 1}


def test_in_place_probes():
    buf = {"a": torch.zeros(3), "b": torch.zeros(2, 2)}
    fresh = {"a": torch.ones(3), "b": torch.ones(2, 2)}
    sanitize.assert_deleted(buf, "off", into=fresh)  # off: a no-op
    assert sanitize.stats["probed"] == 0
    enable_sanitizers("transfers")
    with torch.no_grad():
        for d, s in zip(tree_leaves(buf), tree_leaves(fresh)):
            d.copy_(s)
    sanitize.assert_deleted(buf, "in place", into=buf)
    with pytest.raises(sanitize.DonationViolation, match="2/2"):
        sanitize.assert_deleted(buf, "fresh", into=fresh)
    half = {"a": buf["a"], "b": fresh["b"]}
    with pytest.raises(sanitize.DonationViolation, match="1/2"):
        sanitize.assert_deleted(buf, "half", into=half)
    with pytest.raises(sanitize.DonationViolation, match="split"):
        sanitize.assert_uniformly_deleted(buf, "half", into=half)
    sanitize.assert_uniformly_deleted(buf, "all fresh", into=fresh)
    sanitize.assert_uniformly_deleted(buf, "all in place", into=buf)
    assert sanitize.stats["probed"] == 6
    assert sanitize.deleted_leaves(buf, half) == ([buf["a"]], [buf["b"]])


# ---------------------------------------------------------------------------
# sanitized pipeline runs
# ---------------------------------------------------------------------------


def _grid_pipelined(seed=0, **cfg):
    env = GridWorld(8, size=4, max_steps=20, device="cpu")
    agent_cfg = get_config("paac_vector").replace(
        obs_shape=env.obs_shape, num_actions=env.num_actions)
    return PipelinedRL(env, PAACAgent(agent_cfg, PAACConfig(t_max=5)),
                       lr_schedule=constant(0.01), seed=seed, device="cpu",
                       pipeline=PipelineConfig(**cfg))


def test_device_plane_steady_state_is_sync_free_under_the_sanitizers():
    """The counterpart of the reference's transfer-free pin: the learner
    guards iterations 1..4, the collects every call after the first, the
    probes fire on every update, and the lockcheck verdict rides the hub."""
    enable_sanitizers("locks,transfers")
    prl = _grid_pipelined(queue_depth=2)
    assert prl._plane == "device"
    iters = 5
    res = prl.run(iters)
    assert np.isfinite(res.mean_metrics["loss"])
    assert sanitize.stats["guarded"] == (iters - 1) + (iters - 1)
    assert sanitize.stats["probed"] == 2 * iters
    assert sanitize.host_syncs["refused"] == 0
    assert sanitize.edge_stats == {"metrics drain": [1, 0]}
    rep = prl.telemetry.reports["lockcheck"]
    assert rep["cycles"] == [] and rep["hazards"] == []


@pytest.mark.parametrize("clip", [1.0, INF])
def test_the_sanitized_run_is_bitwise_the_plain_one(clip):
    runs = []
    for modes in ("", "locks,transfers"):
        enable_sanitizers(modes) if modes else disable_sanitizers()
        prl = _grid_pipelined(seed=3, queue_depth=1, lockstep=True,
                              rho_bar=clip, c_bar=clip)
        runs.append((prl.run(6), prl))
    (ra, a), (rb, b) = runs
    assert ra.mean_metrics == rb.mean_metrics
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert sanitize.stats["probed"] == 12


def test_a_stray_sync_in_the_guarded_learner_step_raises_on_the_learner():
    enable_sanitizers("transfers")
    prl = _grid_pipelined(queue_depth=2)
    step, calls = prl._update_step, []

    def stray(*a):
        out = step(*a)
        calls.append(threading.current_thread().name)
        if len(calls) == 3:  # iteration 2: guarded
            warnings.warn(SYNC, UserWarning)  # a stray .item()
        return out

    prl._update_step = stray
    with pytest.raises(sanitize.HostSyncViolation) as e:
        prl.run(6)
    assert repr(threading.current_thread().name) in str(e.value)
    assert len(calls) == 3 and sanitize.host_syncs["refused"] == 1


def test_an_actors_read_back_passes_while_the_learner_is_guarded():
    """The thread host plane: the learner's update is guarded from
    iteration 1 while the actor's collect reads back on every step."""
    enable_sanitizers("transfers")
    agent_cfg = get_config("paac_vector").replace(obs_shape=(8,),
                                                  num_actions=3)
    prl = PipelinedRL(py_bound_spec(8, obs_dim=8, n_workers=2, device="cpu",
                                    spin=20),
                      PAACAgent(agent_cfg, PAACConfig(t_max=5)),
                      lr_schedule=constant(0.003), seed=0, device="cpu",
                      pipeline=PipelineConfig(queue_depth=2))
    act = prl._act

    def act_and_read_back(*a, **kw):
        out = act(*a, **kw)
        warnings.warn(SYNC, UserWarning)  # collect_host's packed copy
        return out

    prl._act = act_and_read_back
    with sanitize.guard():  # arm the hook before the actor's first step
        pass
    with prl:
        assert prl._plane == "host"
        prl.run(6)
    assert sanitize.stats["guarded"] == 1 + 5
    assert sanitize.host_syncs == {"unguarded": 6 * 5, "allowed": 0,
                                   "refused": 0}


# ---------------------------------------------------------------------------
# the trainer's --sanitize and the serving CLI's observers
# ---------------------------------------------------------------------------

CI_SHAPE = ["--arch", "paac_vector", "--device", "cpu", "--iterations", "8",
            "--pipeline", "--num-actors", "2", "--n-envs", "8", "--sanitize",
            "locks,transfers"]


@pytest.mark.parametrize("leg", [[], ["--algo", "dqn", "--replay",
                                      "--replay-capacity", "16",
                                      "--replay-batch", "2"]],
                         ids=["paac", "replay-dqn"])
def test_train_cli_sanitized_runs_at_cis_shape(leg):
    rl, (res,) = train.run_rl(train.build_parser().parse_args(CI_SHAPE
                                                              + leg))
    assert res.steps == 8 * 4 * 8
    # each actor's first collect builds; the learner guards iterations 1..7
    assert sanitize.stats["guarded"] == 7 + (8 - 2)
    assert sanitize.stats["probed"] == 2 * 8
    rep = rl.telemetry.reports["lockcheck"]
    assert rep["cycles"] == [] and rep["hazards"] == []
    if leg:
        assert sanitize.edge_stats["replay sample draw"][0] == 8
    # armed for the call only
    assert not sanitizer_enabled("locks") and not sanitizer_enabled(
        "transfers")


def test_sanitize_exits_come_with_the_references_text():
    for argv in (["--sanitize", "locks"], ["--pipeline", "--sanitize",
                                           "locks,bogus"]):
        with pytest.raises(SystemExit) as want:
            ref_train.run_rl(train.build_parser().parse_args(argv))
        with pytest.raises(SystemExit) as got:
            train.main(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value)


def test_a_lock_order_finding_fails_the_launch(monkeypatch):
    class Inverting(PipelinedRL):
        def run(self, iterations, log_every=0):
            a, b = make_lock("supervisor.lock"), make_condition("queue.cond")
            with a:
                with b:
                    pass
            th = threading.Thread(target=lambda: [b.acquire(), a.acquire(),
                                                  a.release(), b.release()])
            th.start()
            th.join(timeout=10)
            return super().run(iterations, log_every)

    monkeypatch.setattr(train, "PipelinedRL", Inverting)
    with pytest.raises(SystemExit, match=r"lockcheck: 1 cycle\(s\), 0 "
                       r"hazard\(s\)"):
        train.main(["--arch", "paac_vector", "--device", "cpu", "--n-envs",
                    "4", "--t-max", "3", "--iterations", "3", "--pipeline",
                    "--sanitize", "locks"])


SERVE = ["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
         "--continuous", "--requests", "4", "--slots", "2", "--prompt-len",
         "16", "--gen", "8"]


def test_serve_cli_writes_the_trace_and_the_heartbeat(tmp_path):
    trace, beat = tmp_path / "serve.json", tmp_path / "serve.jsonl"
    res = serve.main(SERVE + ["--trace", str(trace), "--metrics-jsonl",
                              str(beat)])
    plain = serve.main(SERVE)
    assert [r.tokens.tolist() for r in res["requests"]] == [
        r.tokens.tolist() for r in plain["requests"]]
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"admit", "prefill", "decode"} <= names
    lines = [json.loads(x) for x in beat.read_text().splitlines()]
    served = [x for x in lines if "serve_queue_depth" in x]
    assert served and "serve_active_slots" in served[-1]
    assert served[-1]["steps"] == res["steps"]  # the scheduler's counter


def test_serve_lockstep_demo_traces_prefill_and_decode(tmp_path):
    trace = tmp_path / "demo.json"
    res = serve.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3",
                      "--trace", str(trace)])
    assert res["tokens"].shape == (2, 4)
    events = json.loads(trace.read_text())["traceEvents"]
    spans = [e["name"] for e in events if e.get("ph") == "X"]
    assert spans.count("prefill") == 1 and spans.count("decode") == 3


def test_serve_main_keeps_nothing_of_its_params(monkeypatch, tmp_path):
    """With the hub's gauges registered, nothing outlives ``main`` that
    holds the engine: its params are freed on return, without waiting for
    the cyclic collector (a leak of one model a call on the card)."""
    import gc
    import weakref

    refs, real = [], serve.init_policy

    def init(*a, **kw):
        params = real(*a, **kw)
        refs.append(weakref.ref(tree_leaves(params)[0]))
        return params

    monkeypatch.setattr(serve, "init_policy", init)
    gc.disable()
    try:
        serve.main(SERVE + ["--trace", str(tmp_path / "t.json"),
                            "--metrics-jsonl", str(tmp_path / "m.jsonl")])
        assert refs[0]() is None
    finally:
        gc.enable()

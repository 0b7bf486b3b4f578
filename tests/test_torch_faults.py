"""The port's fault injection and actor supervision (CPU, small shapes).

Mirrors of ``tests/test_faults.py``, torch against torch:

* ``FaultPlan`` validates its schedule and every entry fires exactly once;
* without ``elastic`` the pipeline stays fail-fast: an injected kill
  propagates as the same ``RuntimeError`` a real crash gives;
* with ``elastic`` a killed replica respawns under the restart budget and
  the run completes its *full* quota under a fresh ``(actor_id, seq)``
  epoch; past the budget the run degrades to the survivors, who absorb the
  dead replica's quota through the ``QuotaLedger``;
* survivors wait on the ledger instead of checking out while orphaned
  quota is outstanding; the last live replica dying is a clean error,
  never a hang; a replica crashing while its sibling is blocked in
  ``put()`` recovers without deadlock;
* param leases are attributable (``holders``, ``revoke``, the timeout
  names the holder); learner-side injections (a stall, a dropped release)
  are absorbed by the pipeline's sizing;
* the process backend recovers from a planned ``error`` and from a hard
  ``os._exit``.

Beyond the mirrors: a thread respawn starts from its predecessor's last
rollout boundary (fresh generators, never the dead ones), a process plane
reused across runs first reuses its errored child and then retires an
exited one to the graveyard, and after ``close()`` no worker lives and no
segment of the plane — the graveyard's included — is left in
``/dev/shm``; the last worker's death is a clean error within 120 s.

Torch's intra-op threads are capped at 2 here, and the process plane hands
that cap to its children. A spawned child costs a few seconds here.
"""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import PipelineConfig, get_config  # noqa: E402
from repro_torch.core.agents import PAACAgent, PAACConfig  # noqa: E402
from repro_torch.envs import GridWorld, HostEnvPool, py_bound_spec  # noqa: E402
from repro_torch.pipeline import (ActorSupervisor, FaultInjector,  # noqa: E402
                                  FaultPlan, InjectedActorFault,
                                  PingPongParamSlot, PipelinedRL,
                                  QuotaLedger)
from repro_torch.utils.tree import tree_leaves  # noqa: E402


def _grid():
    return GridWorld(8, size=4, max_steps=20, device="cpu")


def _grid_agent(t_max=3):
    env = _grid()
    cfg = get_config("paac_vector").replace(
        obs_shape=env.obs_shape, num_actions=env.num_actions)
    return _grid(), PAACAgent(cfg, PAACConfig(t_max=t_max))


class _ToyGymEnv:
    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.state = 0

    def reset(self):
        self.state = int(self.rng.randint(0, 100))
        return np.array([self.state % 7], np.float32)

    def step(self, action):
        reward = 1.0 if action == self.state % 3 else 0.0
        self.state += 1
        return np.array([self.state % 7], np.float32), reward, \
            self.state % 10 == 0, {}


def _toy_pool(n=4, n_workers=2):
    return HostEnvPool([lambda s=i: _ToyGymEnv(s) for i in range(n)],
                       n_workers=n_workers, obs_shape=(1,), device="cpu")


def _pool_agent(t_max=3):
    cfg = get_config("paac_vector").replace(obs_shape=(1,), num_actions=3)
    return PAACAgent(cfg, PAACConfig(t_max=t_max))


def _piped(env, agent, seed=0, **cfg):
    return PipelinedRL(env, agent, seed=seed, device="cpu",
                       pipeline=PipelineConfig(**cfg))


# ---------------------------------------------------------------------------
# FaultPlan / config validation
# ---------------------------------------------------------------------------


def test_fault_plan_validates_entries():
    with pytest.raises(ValueError, match="mode"):
        FaultPlan(kills=((0, 1, "segfault"),))
    with pytest.raises(ValueError, match=">= 0"):
        FaultPlan(kills=((-1, 0, "error"),))
    with pytest.raises(ValueError, match=">= 0"):
        FaultPlan(lease_delays=((0, 0, -1.0),))
    with pytest.raises(ValueError, match=">= 0"):
        FaultPlan(drop_release=(-2,))
    with pytest.raises(ValueError, match=">= 0"):
        FaultPlan(stall_learner=((0, -0.1),))
    # frozen: the plan rides an (immutable) config
    plan = FaultPlan(kills=((0, 1, "error"),))
    with pytest.raises(Exception):
        plan.kills = ()


def test_fault_injector_entries_fire_exactly_once():
    inj = FaultInjector(FaultPlan(kills=((0, 2, "error"), (1, 0, "exit")),
                                  drop_release=(1,)))
    with pytest.raises(InjectedActorFault):
        inj.maybe_kill(0, 2)
    inj.maybe_kill(0, 2)  # fired: the respawned replica sails through
    inj.maybe_kill(1, 2)  # a different count: never planned
    assert inj.drop_release(1) is True
    assert inj.drop_release(1) is False
    # claimed for a worker's run command once, never again
    assert inj.kills_for_worker(1) == ((0, "exit"),)
    assert inj.kills_for_worker(1) == ()


def test_config_validates_fault_fields():
    with pytest.raises(ValueError, match="restart_budget"):
        PipelineConfig(restart_budget=-1)
    with pytest.raises(ValueError, match="lease_timeout_s"):
        PipelineConfig(lease_timeout_s=0.0)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        PipelineConfig(checkpoint_every=5)
    with pytest.raises(ValueError, match="mesh"):
        PipelineConfig(elastic=True, mesh_shape=2, num_actors=2)
    with pytest.raises(ValueError, match="mesh"):
        PipelineConfig(elastic=True, rollout_plane="mesh")


def test_orchestrator_rejects_non_fault_plan():
    env, agent = _grid_agent()
    with pytest.raises(TypeError, match="FaultPlan"):
        _piped(env, agent, fault_plan={"kills": []})


# ---------------------------------------------------------------------------
# fail-fast default (elastic off)
# ---------------------------------------------------------------------------


def test_injected_kill_fails_fast_without_elastic():
    env, agent = _grid_agent()
    prl = _piped(env, agent, queue_depth=2, num_actors=2,
                 fault_plan=FaultPlan(kills=((0, 1, "error"),)))
    with pytest.raises(RuntimeError, match="pipeline actor") as ei:
        prl.run(8)
    assert isinstance(ei.value.__cause__, InjectedActorFault)
    assert prl.supervisor is None  # fail-fast: no supervisor built


# ---------------------------------------------------------------------------
# elastic recovery: respawn and degrade
# ---------------------------------------------------------------------------


def test_thread_respawn_completes_full_quota():
    """Kill one of two replicas mid-run: the supervisor respawns it under a
    fresh actor_id epoch and the run completes every one of its updates."""
    env, agent = _grid_agent()
    prl = _piped(env, agent, queue_depth=2, num_actors=2, elastic=True,
                 restart_budget=1, restart_backoff_s=0.01,
                 fault_plan=FaultPlan(kills=((0, 2, "error"),)))
    res = prl.run(8)
    assert np.isfinite(res.mean_metrics["loss"])
    assert len(prl.learned_ids) == 8
    sup = prl.supervisor
    assert ("respawn", 0, 2) in sup.episodes
    assert 2 in {a for a, _ in prl.learned_ids}
    # slot 0's stream: 2 rollouts from the dead epoch, the rest fresh
    dead = sorted(s for a, s in prl.learned_ids if a == 0)
    fresh = sorted(s for a, s in prl.learned_ids if a == 2)
    assert dead == [0, 1] and fresh == [0, 1]
    counters = prl.telemetry._counters
    assert counters.get("fault.detect") == 1
    assert counters.get("fault.respawn") == 1


def test_degrade_to_fewer_actors_when_budget_exhausted():
    """restart_budget=0: the dead slot's quota is orphaned to the ledger and
    the surviving replica absorbs it — the run still completes in full."""
    env, agent = _grid_agent()
    prl = _piped(env, agent, queue_depth=2, num_actors=2, elastic=True,
                 restart_budget=0,
                 fault_plan=FaultPlan(kills=((0, 1, "error"),)))
    res = prl.run(8)
    assert np.isfinite(res.mean_metrics["loss"])
    assert len(prl.learned_ids) == 8
    sup = prl.supervisor
    assert any(e[0] == "giveup" and e[1] == 0 for e in sup.episodes)
    assert not any(e[0] == "respawn" for e in sup.episodes)
    survivor = [s for a, s in prl.learned_ids if a == 1]
    assert len(survivor) == 7 and sorted(survivor) == list(range(7))
    assert prl.telemetry._counters.get("fault.giveup") == 1


def test_a_fault_before_a_sibling_has_started_degrades(monkeypatch):
    """F15: ``PipelinedRL.run`` starts its replicas one after another, so
    a replica can die before its sibling has started. Actor 1's start is
    held back here until actor 0 has died: the supervisor must count the
    registered, not yet started sibling as live and degrade to it, not
    abort with "last live actor died"."""
    from repro_torch.pipeline import actor as actor_mod

    started = {}
    real_start = actor_mod.ActorThread.start

    def start(self):
        if self.actor_id == 1 and 0 in started:
            started[0].join(timeout=60)
            assert not started[0].is_alive()
        started[self.actor_id] = self
        real_start(self)

    monkeypatch.setattr(actor_mod.ActorThread, "start", start)
    env, agent = _grid_agent()
    prl = _piped(env, agent, queue_depth=2, num_actors=2, elastic=True,
                 restart_budget=0,
                 fault_plan=FaultPlan(kills=((0, 1, "error"),)))
    res = prl.run(8)
    assert set(started) == {0, 1}
    assert np.isfinite(res.mean_metrics["loss"])
    assert len(prl.learned_ids) == 8
    sup = prl.supervisor
    assert sup.fatal is None
    assert any(e[0] == "giveup" and e[1] == 0 for e in sup.episodes)
    survivor = [s for a, s in prl.learned_ids if a == 1]
    assert len(survivor) == 7 and sorted(survivor) == list(range(7))


def test_last_actor_death_is_fatal_not_a_hang():
    env, agent = _grid_agent()
    prl = _piped(env, agent, queue_depth=1, num_actors=1, elastic=True,
                 restart_budget=0,
                 fault_plan=FaultPlan(kills=((0, 1, "error"),)))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="after faults") as ei:
        prl.run(6)
    assert time.monotonic() - t0 < 120
    assert isinstance(ei.value.__cause__, InjectedActorFault)
    assert prl.supervisor.fatal is not None


def test_respawn_after_sibling_finished_quota():
    """The respawn-vs-producer_done race: the ledger keeps the survivor
    from checking out while the orphaned work is outstanding."""
    env, agent = _grid_agent(t_max=2)
    # uneven split: quota [3, 2]; slot 1 dies before producing anything
    prl = _piped(env, agent, queue_depth=2, num_actors=2, elastic=True,
                 restart_budget=0,
                 fault_plan=FaultPlan(kills=((1, 0, "error"),)))
    res = prl.run(5)
    assert np.isfinite(res.mean_metrics["loss"])
    assert len(prl.learned_ids) == 5
    assert all(a == 0 for a, _ in prl.learned_ids)


def test_crash_while_sibling_blocked_in_put():
    """A stalled learner fills the depth-1 ring so the sibling blocks in
    put(); the kill then fires and the recovery episode completes without
    deadlock (the supervisor runs on the dying thread while the ring is
    full)."""
    env, agent = _grid_agent(t_max=2)
    prl = _piped(env, agent, queue_depth=1, num_actors=2, elastic=True,
                 restart_budget=1, restart_backoff_s=0.01,
                 fault_plan=FaultPlan(kills=((0, 1, "error"),),
                                      stall_learner=((0, 0.5),)))
    res = prl.run(6)
    assert np.isfinite(res.mean_metrics["loss"])
    assert len(prl.learned_ids) == 6


def test_zero_budget_no_fault_matches_failfast_stream():
    """elastic with an empty fault plan consumes the same payload stream a
    fail-fast run does (supervision is scaffolding until a fault fires)."""
    _, agent = _grid_agent(t_max=2)
    pipe = dict(queue_depth=2, num_actors=2)
    a = _piped(_grid(), agent, seed=3, **pipe)
    a.run(6)
    b = _piped(_grid(), agent, seed=3, elastic=True, restart_budget=0, **pipe)
    b.run(6)
    assert sorted(a.learned_ids) == sorted(b.learned_ids)


def test_thread_respawn_starts_from_the_last_boundary():
    """A respawned thread replica gets fresh generators whose states are
    its predecessor's after its last successful collect; with one actor
    in lockstep the respawned run therefore learns what an unfaulted run
    learns, and the slot's generators come back at the same states."""
    _, agent = _grid_agent(t_max=2)
    inf = float("inf")
    pipe = dict(queue_depth=1, lockstep=True, rho_bar=inf, c_bar=inf)
    a = _piped(_grid(), agent, **pipe)
    a.run(6)
    b = _piped(_grid(), agent, elastic=True, restart_backoff_s=0.0,
               fault_plan=FaultPlan(kills=((0, 3, "error"),)), **pipe)
    b.run(6)
    assert b.supervisor.episodes == [("respawn", 0, 1)]
    assert b.learned_ids == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(p, q)
    for ga, gb in zip(a._actor_keys[0], b._actor_keys[0]):
        assert torch.equal(ga.get_state(), gb.get_state())
    dead, new = b.supervisor.all_actors()
    assert all(g is not h for g, h in zip(new._key, dead._key))


# ---------------------------------------------------------------------------
# lease attribution
# ---------------------------------------------------------------------------


def test_pingpong_holders_and_revoke():
    slot = PingPongParamSlot({"w": torch.zeros(3)}, version=0)
    slot.acquire(holder="actor-0")
    slot.acquire(holder="actor-1")
    assert sorted(slot.holders(0)) == ["actor-0", "actor-1"]
    # a dead replica's leases are cleared wholesale
    assert slot.revoke("actor-0") == 1
    assert slot.holders(0) == ["actor-1"]
    slot.release(0, holder="actor-1")
    assert slot.holders(0) == []
    # publish proceeds now that the buffer is free
    slot.publish({"w": torch.ones(3)}, 2, timeout=1.0)


def test_publish_timeout_names_the_holder():
    slot = PingPongParamSlot({"w": torch.zeros(3)}, version=0)
    slot.acquire(holder="actor-7")
    with pytest.raises(RuntimeError, match="actor-7"):
        slot.publish({"w": torch.ones(3)}, 2, timeout=0.05)


def test_learner_lease_timeout_is_configurable():
    cfg = PipelineConfig(lease_timeout_s=12.5)
    assert cfg.lease_timeout_s == 12.5


# ---------------------------------------------------------------------------
# learner-side injections
# ---------------------------------------------------------------------------


def test_drop_release_absorbed_by_staging_sizing():
    """One deliberately leaked host staging lease is absorbed by the ring's
    queue_depth + 2 sizing — the run completes regardless."""
    agent = _pool_agent()
    with _toy_pool() as pool:
        prl = _piped(pool, agent, queue_depth=1,
                     fault_plan=FaultPlan(drop_release=(1,)))
        res = prl.run(6)
    assert np.isfinite(res.mean_metrics["loss"])
    assert len(prl.learned_ids) == 6


def test_stall_learner_backpressures_without_fault():
    env, agent = _grid_agent(t_max=2)
    prl = _piped(env, agent, queue_depth=1, num_actors=2,
                 fault_plan=FaultPlan(stall_learner=((1, 0.3),)))
    res = prl.run(6)
    assert np.isfinite(res.mean_metrics["loss"])
    assert len(prl.learned_ids) == 6
    # the stall shows as the actors' backpressure
    assert res.actor_idle_s > 0.2


# ---------------------------------------------------------------------------
# quota ledger unit
# ---------------------------------------------------------------------------


def test_quota_ledger_work_conservation():
    led = QuotaLedger(4)
    led.produced()
    led.orphan(2)
    assert led.wait_for_work() == 1  # claims one unit
    assert led.claim() == 1  # takes the rest of the pool
    led.produced()
    led.produced()
    led.produced()
    # outstanding drained: waiters check out immediately
    assert led.wait_for_work() == 0
    led2 = QuotaLedger(5)
    led2.abort()
    assert led2.wait_for_work() == 0
    assert isinstance(ActorSupervisor(None, led, None).episodes, list)


# ---------------------------------------------------------------------------
# process backend recovery
# ---------------------------------------------------------------------------


def _spec_agent(n_envs=4, n_workers=2, t_max=2):
    spec = py_bound_spec(n_envs, obs_dim=3, spin=0, n_workers=n_workers,
                         device="cpu")
    cfg = get_config("paac_vector").replace(obs_shape=spec.obs_shape,
                                            num_actions=3)
    return spec, PAACAgent(cfg, PAACConfig(t_max=t_max))


def _on_dev_shm(names):
    return [n for n in names if os.path.exists("/dev/shm/" + n.lstrip("/"))]


@pytest.mark.parametrize("mode", ["error", "exit"])
def test_process_backend_respawns_dead_worker(mode):
    """Both planned failure shapes — an in-worker exception and a hard
    os._exit (silent death) — recover through a worker respawn and the run
    completes its full quota."""
    spec, agent = _spec_agent()
    prl = _piped(spec, agent, queue_depth=2, num_actors=2,
                 actor_backend="process", elastic=True, restart_budget=1,
                 restart_backoff_s=0.01,
                 fault_plan=FaultPlan(kills=((0, 1, mode),)))
    try:
        res = prl.run(6)
        assert np.isfinite(res.mean_metrics["loss"])
        assert len(prl.learned_ids) == 6
        assert any(e[0] == "respawn" for e in prl.supervisor.episodes)
    finally:
        prl.close()


def test_process_plane_reuses_then_respawns_and_leaves_no_segment():
    """One plane over three runs: an "error" kill reuses the parked child,
    an "exit" kill retires it to the graveyard and spawns one fresh child,
    and a run with no fault after that is whole. After close() no worker
    lives and no segment of the plane, the graveyard's included, is left."""
    spec, agent = _spec_agent()
    prl = _piped(spec, agent, queue_depth=2, num_actors=2,
                 actor_backend="process", elastic=True, restart_budget=1,
                 restart_backoff_s=0.01)
    plane = prl._process_plane
    try:
        first = [w.proc for w in plane._workers]
        for mode, slot in (("error", 1), ("exit", 0)):
            prl.pipeline = PipelineConfig(**{
                **prl.pipeline.__dict__,
                "fault_plan": FaultPlan(kills=((slot, 1, mode),))})
            prl.run(6)
            assert len(prl.learned_ids) == 6
            assert len(set(prl.learned_ids)) == 6
            assert prl.supervisor.episodes == [("respawn", slot, 2)]
        assert plane._workers[1].proc is first[1]  # reused after "error"
        assert plane._workers[0].proc is not first[0]  # spawned after "exit"
        assert [w.proc for w in plane._graveyard] == [first[0]]
        assert first[0].exitcode == 17
        prl.pipeline = PipelineConfig(**{**prl.pipeline.__dict__,
                                         "fault_plan": None})
        prl.run(4)
        assert sorted(prl.learned_ids) == [(0, 0), (0, 1), (1, 0), (1, 1)]
        names = plane.segment_names()
        assert len(names) == 3 * 4 + 2  # three estates of 4 sets, the slot
    finally:
        prl.close()
    assert not any(w.proc.is_alive() for w in plane._handles())
    assert _on_dev_shm(names) == []


def test_last_worker_death_is_a_clean_error():
    spec, agent = _spec_agent(n_envs=2, n_workers=1)
    prl = _piped(spec, agent, queue_depth=1, actor_backend="process",
                 elastic=True, restart_budget=0,
                 fault_plan=FaultPlan(kills=((0, 1, "exit"),)))
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="after faults"):
            prl.run(4)
        assert time.monotonic() - t0 < 120
        assert prl.supervisor.fatal is not None
    finally:
        prl.close()

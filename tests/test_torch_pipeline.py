"""The port's pipeline against the JAX package's (CPU, small shapes).

* One learner step of ``repro_torch.pipeline.make_learner_step`` against
  the JAX ``make_learner_step(fused_publish=False)`` on bridged
  ``paac_vector`` and reduced-width CNN parameters and a replayed
  trajectory, at (ρ̄, c̄) = (1, 1), (2, 1) and (inf, inf): loss, the
  metrics, ``rho_mean``, the clip fractions and every new parameter —
  rtol 1e-4, atol 1e-5 (the tolerance of ``tests/test_torch_rl.py``).
* The reference's pipeline contracts (``tests/test_pipeline.py``), torch
  against torch: the ring's backpressure, never-drop, close and ownership,
  and its refusal of payloads off its device; the ping-pong slot's copies,
  reserve-waits-for-readers, alternation and loud publish; depth-1
  lockstep with infinite clips bitwise ≡ ``ParallelRL`` on GridWorld; the
  published buffers are never the learner's tensors; async staleness and
  ρ; multi-actor never-drop and the env-axis split; an actor's failure
  propagates without deadlock; zero-quota replicas check out.
* Only the learner calls the kernels: every K1/K2 call of a run comes from
  the learner's thread, once an update.
* The host plane (mirrors of the reference's pins, torch against torch):
  the staging ring recycles its sets and a timed-out acquire is loud;
  lockstep at infinite clips on a host pool (and on a ``HostEnvSpec``,
  whose pool the pipeline owns) ≡ the synchronous host ``ParallelRL``,
  bitwise; the depth-1 lockstep forced host plane on a tensor env ≡
  ``ParallelRL``, bitwise; smoke runs on a pool and on four shards, each
  ``(actor_id, seq)`` learned once; the act step's logp is the gather;
  every staging set goes back once, only after its update, so a set
  overwritten with NaN on release changes nothing; a crashing external env
  propagates; the plane refusals; a run's heartbeat lines and watchdog.
* Settings outside the ported planes raise ``NotImplementedError``, and
  ``DQNAgent`` runs on the replay plane; the entry
  point runs with ``--pipeline`` on the CPU and raises without a card
  unless the CPU is asked for.
"""
import json
import logging
import math
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.agents.paac import PAACAgent as JPAACAgent  # noqa: E402
from repro.core.agents.paac import PAACConfig as JPAACConfig  # noqa: E402
from repro.core.rollout import Transition as JTransition  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import make_optimizer as jax_optimizer  # noqa: E402
from repro.pipeline.learner import (  # noqa: E402
    make_learner_step as jax_learner_step)
from repro_torch.configs import PipelineConfig, get_config  # noqa: E402
from repro_torch.core import ParallelRL, RunResult  # noqa: E402
from repro_torch.core.agents import PAACAgent, PAACConfig  # noqa: E402
from repro_torch.core.rollout import Transition  # noqa: E402
from repro_torch.envs import (GridWorld, HostEnvPool,  # noqa: E402
                              py_bound_spec)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import paper_atari  # noqa: E402
from repro_torch.models import init_policy  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.pipeline import (CLOSED, DeviceTrajectoryRing,  # noqa: E402
                                  HostStagingRing, ParamSlot,
                                  PingPongParamSlot, PipelinedRL,
                                  QueueClosed, Rollout, make_host_act_step,
                                  make_learner_step)
from repro_torch.utils.bridge import (params_from_numpy,  # noqa: E402
                                      params_to_numpy)
from repro_torch.utils.tree import tree_leaves  # noqa: E402

INF = float("inf")


# ---------------------------------------------------------------- learner
def _cnn(get):
    """A reduced-width paac_nips: two convs of 8 and 16 features over
    36×36×2 frames, a dense layer of 32."""
    return get("paac_nips").replace(cnn_spec=((8, 8, 4), (16, 4, 2)),
                                    cnn_dense=32, d_model=32,
                                    obs_shape=(36, 36, 2), num_actions=3)


def _vector(get):
    return get("paac_vector").replace(obs_shape=(12,), num_actions=4)


@pytest.mark.parametrize("rho_bar,c_bar", [(1.0, 1.0), (2.0, 1.0),
                                           (INF, INF)])
@pytest.mark.parametrize("make_cfg", [_vector, _cnn], ids=["vector", "cnn"])
def test_one_learner_step_matches_the_reference(make_cfg, rho_bar, c_bar):
    """The same bridged params, optimizer state and replayed trajectory
    (T=4, E=6, behaviour log-probs that make ρ spread over (0.4, 2.7))
    through both learner steps."""
    cfg_j, cfg = make_cfg(jax_config), make_cfg(get_config)
    T, E, lr = 4, 6, 0.0224
    rng = np.random.default_rng(11)
    tr = dict(obs=rng.random((T, E) + tuple(cfg.obs_shape), dtype=np.float32),
              action=rng.integers(0, cfg.num_actions, (T, E)),
              reward=rng.standard_normal((T, E)).astype(np.float32),
              done=rng.random((T, E)) < 0.2,
              value=rng.standard_normal((T, E)).astype(np.float32),
              logp=np.log(rng.uniform(0.15, 0.6, (T, E))).astype(np.float32))
    last_obs = rng.random((E,) + tuple(cfg.obs_shape), dtype=np.float32)

    pj = jax_init(jax.random.PRNGKey(3), cfg_j)
    opt_j = jax_optimizer("rmsprop")
    step_j = jax_learner_step(JPAACAgent(cfg_j, JPAACConfig(t_max=T)), opt_j,
                              jax_constant(lr), rho_bar=rho_bar, c_bar=c_bar)
    traj_j = JTransition(**{k: jnp.asarray(v, jnp.int32 if k == "action"
                                           else None) for k, v in tr.items()})
    new_j, _, m_j = step_j(pj, opt_j.init(pj), traj_j, jnp.asarray(last_obs),
                           0)

    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    opt = make_optimizer("rmsprop")
    step = make_learner_step(PAACAgent(cfg, PAACConfig(t_max=T)), opt,
                             constant(lr), rho_bar=rho_bar, c_bar=c_bar)
    traj_t = Transition(**{k: torch.from_numpy(v) for k, v in tr.items()})
    ops.reset_launches()
    new_t, _, m_t = step(pt, opt.init(pt), traj_t, torch.from_numpy(last_obs),
                         0)
    assert ops.launches["vtrace_returns"] == ops.launches["nstep_returns"] == 0
    for k in ("loss", "policy_loss", "value_loss", "entropy", "rho_mean",
              "rho_clip_frac", "c_clip_frac", "reward_sum", "episodes"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    if math.isfinite(rho_bar):  # the clips bite on this trajectory
        assert 0 < float(m_t["rho_clip_frac"]) < 1
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(new_t)),
                    jax.tree_util.tree_leaves(new_j)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


def test_fused_publish_writes_the_new_params_into_the_reserved_buffer():
    cfg = _vector(get_config)
    opt = make_optimizer("rmsprop")
    step = make_learner_step(PAACAgent(cfg, PAACConfig(t_max=2)), opt,
                             constant(0.01), fused_publish=True)
    params = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    dst = PingPongParamSlot(params).reserve(1, timeout=1.0)
    g = torch.Generator().manual_seed(0)
    traj = Transition(obs=torch.rand(2, 3, 12, generator=g),
                      action=torch.zeros(2, 3, dtype=torch.int64),
                      reward=torch.randn(2, 3, generator=g),
                      done=torch.zeros(2, 3, dtype=torch.bool),
                      value=torch.zeros(2, 3), logp=torch.full((2, 3), -1.0))
    new, _, published, _ = step(params, opt.init(params), traj,
                                torch.rand(3, 12, generator=g), 0, dst)
    assert published is dst
    for p, n in zip(tree_leaves(published), tree_leaves(new)):
        assert torch.equal(p, n) and p.data_ptr() != n.data_ptr()


# ---------------------------------------------------------------- ring
def test_ring_backpressure_blocks_and_never_drops():
    ring = DeviceTrajectoryRing(depth=2, device="cpu")
    n_items = 7
    items = [torch.tensor(i) for i in range(n_items)]
    produced = []

    def producer():
        for i in range(n_items):
            ring.put(items[i])
            produced.append(i)
        ring.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.2)
    assert ring.qsize() == 2
    assert len(produced) == 2  # third put is blocked on a full ring
    got = []
    while True:
        item = ring.get(timeout=5.0)
        if item is CLOSED:
            break
        got.append(int(item))
    t.join(timeout=5.0)
    assert got == list(range(n_items))
    assert ring.tickets_issued == ring.tickets_consumed == n_items
    assert ring.put_wait_s > 0.1  # producer idle accounting saw the block


def test_ring_refuses_payloads_off_its_device():
    """The device plane polices itself: a CPU tensor on a CUDA ring, or a
    numpy array anywhere, means a host staging step crept in."""
    cuda_ring = DeviceTrajectoryRing(depth=2, device="cuda")
    with pytest.raises(TypeError, match="device"):
        cuda_ring.put(torch.zeros(3))
    rollout = Rollout(Transition(*(torch.zeros(2, 3) for _ in range(6))),
                      torch.zeros(3), 0)
    with pytest.raises(TypeError, match="device"):
        cuda_ring.put(rollout)
    ring = DeviceTrajectoryRing(depth=2, device="cpu")
    with pytest.raises(TypeError, match="numpy"):
        ring.put(np.zeros(3))
    with pytest.raises(TypeError, match="meta"):
        ring.put(rollout._replace(last_obs=torch.empty(3, device="meta")))
    ring.put(rollout)  # tensors on the ring's device are accepted
    assert ring.qsize() == 1 and cuda_ring.qsize() == 0


def test_ring_close_wakes_blocked_put_and_drains():
    ring = DeviceTrajectoryRing(depth=1, device="cpu")
    ring.put(torch.tensor(0))
    outcome = {}

    def producer():
        try:
            ring.put(torch.tensor(1), timeout=30.0)
            outcome["result"] = "returned"
        except QueueClosed:
            outcome["result"] = "closed"

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.2)
    ring.close()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert outcome["result"] == "closed"
    assert int(ring.get(timeout=1.0)) == 0  # queued slot still drains
    assert ring.get(timeout=1.0) is CLOSED


def test_ring_multi_producer_done_and_validation():
    ring = DeviceTrajectoryRing(depth=4, producers=2, device="cpu")
    ring.put(torch.tensor(0))
    ring.producer_done()  # first producer checks out early
    ring.put(torch.tensor(1))  # second producer still live
    assert int(ring.get(timeout=1.0)) == 0
    ring.producer_done()
    assert int(ring.get(timeout=1.0)) == 1
    assert ring.get(timeout=1.0) is CLOSED
    with pytest.raises(QueueClosed):
        ring.put(torch.tensor(2))
    with pytest.raises(ValueError):
        DeviceTrajectoryRing(depth=0, device="cpu")
    with pytest.raises(ValueError):
        DeviceTrajectoryRing(depth=1, producers=0, device="cpu")


def test_ring_get_transfers_slot_ownership():
    """After get() the ring holds no reference: the consumer is the
    payload's sole owner, and consuming it cannot disturb later slots."""
    import weakref

    ring = DeviceTrajectoryRing(depth=2, device="cpu")
    ring.put(torch.arange(3))
    ring.put(torch.arange(3, 6))
    got = ring.get(timeout=1.0)
    alive = weakref.ref(got)
    del got
    assert alive() is None  # no reference left behind in the ring
    assert torch.equal(ring.get(timeout=1.0), torch.arange(3, 6))


def test_ring_and_ping_pong_under_thread_stress():
    """Eight producers and four readers on a tiny switch interval: every
    ticket is consumed exactly once, in order per producer, and no reader
    ever sees its leased buffer change under it."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ring = DeviceTrajectoryRing(depth=2, producers=8, device="cpu")
        slot = PingPongParamSlot({"w": torch.zeros(64)}, version=0)
        torn, stop = [], threading.Event()

        def produce(a):
            for s in range(50):
                ring.put((torch.tensor(a), torch.tensor(s)))
            ring.producer_done()

        def read():
            while not stop.is_set():
                params, v, _ = slot.acquire(holder=threading.current_thread().name)
                try:
                    if not bool((params["w"] == v).all()):
                        torn.append(v)
                finally:
                    slot.release(v, holder=threading.current_thread().name)

        threads = ([threading.Thread(target=produce, args=(a,), daemon=True)
                    for a in range(8)]
                   + [threading.Thread(target=read, daemon=True)
                      for _ in range(4)])
        for t in threads:
            t.start()
        got, version = [], 0
        while True:
            item = ring.get(timeout=10.0)
            if item is CLOSED:
                break
            got.append((int(item[0]), int(item[1])))
            version += 1
            slot.publish({"w": torch.full((64,), float(version))}, version,
                         timeout=10.0)
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(got) == [(a, s) for a in range(8) for s in range(50)]
    for a in range(8):
        assert [s for b, s in got if b == a] == list(range(50))
    assert ring.tickets_issued == ring.tickets_consumed == 400
    assert torn == []


# ---------------------------------------------------------------- slots
def test_param_slot_versions():
    slot = ParamSlot("v0", version=0)
    assert slot.read() == ("v0", 0)
    slot.publish("v3", 3)
    assert slot.wait_for(2, timeout=1.0)
    assert slot.acquire() == ("v3", 3, None)
    assert not slot.wait_for(5, timeout=0.05)


def test_ping_pong_slot_snapshots_are_copies():
    """Actors never see the learner's working tensors: the slot copies at
    construction and on publish."""
    params = {"w": torch.arange(4, dtype=torch.float32)}
    slot = PingPongParamSlot(params, version=0)
    seen, v, ready = slot.acquire()
    assert v == 0 and ready is None  # no event on the CPU
    assert seen["w"] is not params["w"]
    assert seen["w"].data_ptr() != params["w"].data_ptr()
    assert torch.equal(seen["w"], params["w"])
    params["w"].add_(100.0)  # the learner changes its own tensors
    assert torch.equal(seen["w"], torch.arange(4, dtype=torch.float32))
    slot.release(v)


def test_ping_pong_reserve_waits_for_readers():
    """reserve(v) must not hand out buffer v%2 while a reader of its current
    contents is still live — the race that would corrupt a rollout."""
    slot = PingPongParamSlot({"w": torch.zeros(2)}, version=0)
    params, v, _ = slot.acquire()  # lease buffer 0 (version 0)
    assert slot.reserve(2, timeout=0.1) is None  # buffer 0 busy: times out
    assert slot.reserve(1, timeout=0.1) is not None  # buffer 1 is free
    done = {}

    def learner():
        done["dst"] = slot.reserve(2, timeout=5.0)  # blocks on the lease

    t = threading.Thread(target=learner, daemon=True)
    t.start()
    time.sleep(0.1)
    assert "dst" not in done
    slot.release(v)
    t.join(timeout=5.0)
    assert done["dst"] is params  # the stale buffer, to overwrite in place


def test_ping_pong_revoke_clears_a_dead_readers_leases():
    slot = PingPongParamSlot({"w": torch.zeros(2)}, version=0)
    slot.acquire(holder="actor-7")
    slot.acquire(holder="actor-7")
    assert slot.holders(0) == ["actor-7", "actor-7"]
    assert slot.reserve(2, timeout=0.05) is None
    assert slot.revoke("actor-7") == 2 and slot.holders(0) == []
    assert slot.reserve(2, timeout=0.05) is not None


def test_ping_pong_publish_alternates_and_versions():
    slot = PingPongParamSlot({"w": torch.zeros(2)}, version=0)
    seen = set()
    for ver in (1, 2, 3):
        slot.publish({"w": torch.full((2,), float(ver))}, ver)
        params, v, _ = slot.acquire()
        assert v == ver
        assert torch.equal(params["w"], torch.full((2,), float(ver)))
        seen.add(params["w"].data_ptr())
        slot.release(v)
    assert slot.wait_for(3, timeout=0.1)
    assert len(seen) == 2  # two buffers, written in place in turn


def test_ping_pong_publish_raises_loudly_on_leased_buffer():
    slot = PingPongParamSlot({"w": torch.zeros(2)}, version=0)
    params, v, _ = slot.acquire()  # lease buffer 0; version-2 publish needs it
    with pytest.raises(RuntimeError, match="still leased"):
        slot.publish({"w": torch.ones(2)}, 2, timeout=0.1)
    assert torch.equal(params["w"], torch.zeros(2))  # never clobbered
    slot.release(v)
    slot.publish({"w": torch.ones(2)}, 2, timeout=0.1)  # now fine
    assert slot.version == 2


# ---------------------------------------------------------------- runs
def _grid(n=8):
    return GridWorld(n, size=4, max_steps=20, device="cpu")


def _grid_agent(t_max=5):
    env = _grid()
    cfg = get_config("paac_vector").replace(obs_shape=env.obs_shape,
                                            num_actions=env.num_actions)
    return PAACAgent(cfg, PAACConfig(t_max=t_max))


def _pipelined(env=None, seed=0, lr=0.01, **cfg):
    return PipelinedRL(env if env is not None else _grid(), _grid_agent(),
                       lr_schedule=constant(lr), seed=seed, device="cpu",
                       pipeline=PipelineConfig(**cfg))


def test_lockstep_infinite_clips_bitwise_vs_sync():
    """Depth 1, lockstep, ρ̄ = c̄ = ∞: the pipeline reproduces synchronous
    ``ParallelRL``'s metrics and parameters bit for bit, over two runs."""
    rl = ParallelRL(_grid(), _grid_agent(), lr_schedule=constant(0.01),
                    seed=1, device="cpu")
    prl = _pipelined(seed=1, queue_depth=1, rho_bar=INF, c_bar=INF,
                     lockstep=True)
    for n in (10, 4):
        r_sync, r_pipe = rl.run(n), prl.run(n)
        assert r_pipe.mean_metrics["staleness"] == 0.0
        assert prl.staleness == [0.0] * n
        for k in ("loss", "policy_loss", "value_loss", "entropy",
                  "reward_sum", "episodes"):
            assert r_pipe.mean_metrics[k] == r_sync.mean_metrics[k], k
        assert r_pipe.steps == r_sync.steps == rl.total_steps
        for a, b in zip(tree_leaves(rl.params), tree_leaves(prl.params)):
            assert torch.equal(a, b)


def test_only_the_learner_calls_the_kernels_once_an_update(monkeypatch):
    """K1 at infinite clips, K2 at finite ones: each called once an update,
    always from the learner's thread — actors never call ``ops``."""
    calls = []
    for name in ("nstep_returns", "vtrace_returns"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, threading.current_thread().name))
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, spy)
    learner = threading.current_thread().name
    _pipelined(queue_depth=1, rho_bar=INF, c_bar=INF, lockstep=True).run(3)
    assert calls == [("nstep_returns", learner)] * 3
    calls.clear()
    _pipelined(queue_depth=2, num_actors=2).run(5)
    assert calls == [("vtrace_returns", learner)] * 5


def test_published_buffers_are_never_the_learners_tensors(monkeypatch):
    """PyTorch's counterpart of the reference's donation pin: actors only
    ever lease the two published buffers, which are never the learner's
    working params or optimizer state, and a second run works. Lockstep
    makes the four rollouts lease versions 0-3, so both buffers in turn."""
    prl = _pipelined(queue_depth=1, lockstep=True)
    leased = []
    real = PingPongParamSlot.acquire

    def acquire(self, holder=None):
        out = real(self, holder)
        leased.append({t.data_ptr() for t in tree_leaves(out[0])})
        return out

    monkeypatch.setattr(PingPongParamSlot, "acquire", acquire)
    before = {t.data_ptr() for t in tree_leaves(prl.params)}
    prl.run(4)
    monkeypatch.undo()
    learner = ({t.data_ptr() for t in tree_leaves(prl.params)}
               | {t.data_ptr() for t in tree_leaves(prl.opt_state)})
    assert len(leased) == 4 and len({frozenset(s) for s in leased}) == 2
    assert all(not (s & learner) and not (s & before) for s in leased)
    res = prl.run(3)
    assert math.isfinite(res.mean_metrics["loss"])


def test_async_pipeline_reports_staleness_and_rho():
    prl = _pipelined(queue_depth=2, rho_bar=1.0)
    res = prl.run(12)
    assert res.steps == 12 * 8 * 5
    assert res.mean_metrics["staleness"] > 0.0  # the actor ran ahead
    assert max(prl.staleness) <= 2 + 1
    assert 0.5 < res.mean_metrics["rho_mean"] < 2.0
    assert 0.0 <= res.mean_metrics["rho_clip_frac"] <= 1.0
    assert sorted(prl.learned_ids) == [(0, s) for s in range(12)]
    assert res.learner_idle_s >= 0.0 and res.actor_idle_s >= 0.0


def test_multi_actor_never_drops_and_merges_idle_accounting():
    prl = _pipelined(_grid(6), queue_depth=2, num_actors=3)
    res = prl.run(9)
    assert res.steps == 9 * 2 * 5  # each rollout is one 2-env shard
    assert sorted(prl.learned_ids) == [(a, s) for a in range(3)
                                       for s in range(3)]
    assert len(res.per_actor_idle_s) == 3
    assert res.actor_idle_s == pytest.approx(sum(res.per_actor_idle_s))
    assert all(t >= 0.0 for t in res.per_actor_idle_s)


def test_multi_actor_env_axis_split_and_per_actor_envs():
    """A single env is split along the env axis (2 actors on 8 envs collect
    4-env rollouts); a list of envs gives each replica its own."""
    prl = _pipelined(queue_depth=2, num_actors=2)
    assert [e.n_envs for e in prl._actor_envs] == [4, 4]
    res = prl.run(6)
    assert res.steps == 6 * 4 * 5
    assert sorted(prl.learned_ids) == [(a, s) for a in range(2)
                                       for s in range(3)]
    assert math.isfinite(res.mean_metrics["loss"])
    prl = _pipelined([_grid(4), _grid(4)], queue_depth=2, num_actors=2)
    assert prl.run(4).steps == 4 * 4 * 5
    with pytest.raises(ValueError, match="per-actor envs"):
        _pipelined([_grid(4)], num_actors=2)
    with pytest.raises(ValueError, match="cannot split"):
        _pipelined(_grid(5), num_actors=2)


class _ExplodingGrid(GridWorld):
    def _step_batch(self, state, actions, generator):
        raise RuntimeError("emulator crashed")


def test_actor_failure_propagates():
    prl = _pipelined(_ExplodingGrid(4, size=4, device="cpu"), queue_depth=2)
    with pytest.raises(RuntimeError, match="actor 0 failed") as info:
        prl.run(3)
    assert "emulator crashed" in str(info.value.__cause__)


def test_multi_actor_one_crash_propagates_without_deadlock():
    envs = [_grid(2), _ExplodingGrid(2, size=4, device="cpu"), _grid(2)]
    prl = _pipelined(envs, queue_depth=1, num_actors=3)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="actor 1"):
        prl.run(30)
    assert time.perf_counter() - t0 < 60.0  # unwound, not deadlocked


def test_zero_quota_actors_check_out_cleanly():
    prl = _pipelined(_grid(6), queue_depth=2, num_actors=3)
    res = prl.run(2)
    assert sorted(prl.learned_ids) == [(0, 0), (1, 0)]
    assert res.per_actor_idle_s[2] == 0.0


def test_trace_shows_actor_ring_and_learner_tracks(tmp_path):
    path = tmp_path / "trace.json"
    prl = _pipelined(queue_depth=2, num_actors=2, trace_path=str(path))
    prl.run(4)
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["args"]["name"] for e in events if e["ph"] == "M"
             and e["name"] == "thread_name"}
    assert {"learner", "ring", "actor0", "actor1"} <= names
    spans = {e["name"] for e in events if e["ph"] == "X"}
    assert {"collect", "learner.update", "publish",
            "queue.get_wait"} <= spans
    assert prl.telemetry.counter("steps") == 4 * 4 * 5
    assert prl.telemetry.gauges()["queue_depth"] == 0


# ---------------------------------------------------------------- host plane
def test_host_staging_ring_recycles_sets():
    ring = HostStagingRing(3, t_max=2, n_envs=4, obs_shape=(5,))
    a = ring.acquire()
    b = ring.acquire()
    c = ring.acquire()
    assert ring.free_sets() == 0
    assert a.traj.obs.shape == (2, 4, 5) and a.last_obs.shape == (4, 5)
    assert a.traj.action.dtype == torch.int64
    # the numpy views the host loop writes are the tensors' own memory
    a.np_traj.reward[1, 2] = 7.0
    a.np_last_obs[3] = 1.5
    assert float(a.traj.reward[1, 2]) == 7.0
    assert bool((a.last_obs[3] == 1.5).all())
    assert not a.traj.obs.is_pinned()  # page-locked only on a CUDA run
    ring.release(b)
    assert ring.acquire() is b  # LIFO reuse of the hot set
    ring.release(a)
    ring.release(c)


def test_host_staging_ring_acquire_timeout_is_loud():
    ring = HostStagingRing(2, t_max=1, n_envs=1, obs_shape=())
    ring.acquire()
    ring.acquire()
    with pytest.raises(RuntimeError, match="release"):
        ring.acquire(timeout=0.1)
    with pytest.raises(ValueError):
        HostStagingRing(1, t_max=1, n_envs=1, obs_shape=())


def _host_agent(obs_dim=8, t_max=5):
    cfg = get_config("paac_vector").replace(obs_shape=(obs_dim,),
                                            num_actions=3)
    return PAACAgent(cfg, PAACConfig(t_max=t_max))


def _spec(n=8, n_workers=4, **kw):
    return py_bound_spec(n, obs_dim=8, n_workers=n_workers, device="cpu",
                         **kw)


def _host_pipelined(env, seed=0, t_max=5, **cfg):
    return PipelinedRL(env, _host_agent(t_max=t_max),
                       lr_schedule=constant(0.003), seed=seed, device="cpu",
                       pipeline=PipelineConfig(**cfg))


def _assert_bitwise(r_a, a, r_b, b):
    for k in ("loss", "policy_loss", "value_loss", "entropy", "reward_sum",
              "episodes"):
        assert r_a.mean_metrics[k] == r_b.mean_metrics[k], k
    assert r_a.steps == r_b.steps
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("as_spec", [False, True], ids=["pool", "spec"])
def test_lockstep_infinite_clips_bitwise_vs_sync_on_a_host_pool(as_spec):
    """Single actor, depth 1, ρ̄ = c̄ = ∞ on a host pool (or a spec the
    pipeline builds, owns and closes) ≡ the synchronous host ParallelRL,
    bitwise, over two runs: the same learner step, the same staged
    trajectories."""
    with _spec().build() as pool:
        rl = ParallelRL(pool, _host_agent(), lr_schedule=constant(0.003),
                        seed=1, device="cpu")
        r_sync = [rl.run(8), rl.run(3)]
    with _spec().build() as pool:
        prl = _host_pipelined(_spec() if as_spec else pool, seed=1,
                              queue_depth=1, rho_bar=INF, c_bar=INF,
                              lockstep=True)
        assert prl._plane == "host"
        r_pipe = [prl.run(8), prl.run(3)]
        prl.close()
        prl.close()  # idempotent
        owned = prl.env if as_spec else None
    assert all(r.mean_metrics["staleness"] == 0.0 for r in r_pipe)
    _assert_bitwise(r_pipe[1], prl, r_sync[1], rl)
    assert r_pipe[0].mean_metrics == {**r_sync[0].mean_metrics,
                                      "staleness": 0.0}
    if as_spec:  # the pool built from the spec was closed by close()
        with pytest.raises(RuntimeError, match="closed env pool"):
            owned.reset()


def test_forced_host_plane_depth1_lockstep_bitwise_vs_sync():
    """The GA3C-style baseline: a tensor env's trajectories staged to host
    sets and copied back — losslessly, so lockstep ≡ ParallelRL bitwise."""
    rl = ParallelRL(_grid(), _grid_agent(), lr_schedule=constant(0.01),
                    seed=1, device="cpu")
    r_sync = rl.run(10)
    prl = _pipelined(seed=1, queue_depth=1, rho_bar=INF, c_bar=INF,
                     lockstep=True, rollout_plane="host")
    assert prl._plane == "host"
    r_pipe = prl.run(10)
    assert prl.staleness == [0.0] * 10
    _assert_bitwise(r_pipe, prl, r_sync, rl)


def test_host_plane_smoke_on_a_pool_and_on_four_shards():
    with _spec(16).build() as pool:
        prl = _host_pipelined(pool, queue_depth=2)
        res = prl.run(6)
        assert res.steps == 6 * 16 * 5
        assert math.isfinite(res.mean_metrics["loss"]) and res.episodes > 0
        assert max(prl.staleness) <= 2 + 1
        prl = _host_pipelined(pool, queue_depth=4, num_actors=4)
        assert [e.n_envs for e in prl._actor_envs] == [4] * 4
        assert all(e._parent is pool for e in prl._actor_envs)
        res = prl.run(12)
        assert res.steps == 12 * 4 * 5  # one 4-env shard a rollout
        assert sorted(prl.learned_ids) == [(a, s) for a in range(4)
                                           for s in range(3)]
        assert res.actor_idle_s == pytest.approx(sum(res.per_actor_idle_s))
        assert math.isfinite(res.mean_metrics["loss"])
    # per-actor pools (GA3C's sweep), each a spec the pipeline owns
    prl = _host_pipelined([_spec(4, 2, base_seed=4 * a) for a in range(2)],
                          queue_depth=2, num_actors=2, t_max=3)
    assert prl.run(6).steps == 6 * 4 * 3
    prl.close()


def test_host_plane_releases_each_set_once_after_its_update(monkeypatch):
    """The release protocol: every payload's set goes back exactly once,
    after its update has read it — so a set overwritten with NaN the moment
    it is released changes no loss and no parameter."""
    events, real_release = [], HostStagingRing.release

    def release(self, s, poison=False):
        events.append(("release", id(s)))
        if poison:
            for t in s.traj + (s.last_obs,):
                if t.dtype.is_floating_point:
                    t.fill_(float("nan"))
        real_release(self, s)

    real_step = make_learner_step

    def step_spy(*a, **kw):
        inner = real_step(*a, **kw)

        def step(params, opt_state, traj, last_obs, *rest):
            events.append(("update", None))
            return inner(params, opt_state, traj, last_obs, *rest)

        return step

    runs = []
    for poison in (False, True):
        monkeypatch.setattr(HostStagingRing, "release",
                            lambda self, s, p=poison: release(self, s, p))
        monkeypatch.setattr("repro_torch.pipeline.orchestrator."
                            "make_learner_step", step_spy)
        events.clear()
        with _spec().build() as pool:
            prl = _host_pipelined(pool, seed=2, queue_depth=1, rho_bar=INF,
                                  c_bar=INF, lockstep=True)
            res = prl.run(6)
        runs.append((res, prl))
        kinds = [k for k, _ in events]
        assert kinds == ["update", "release"] * 6
        assert len({i for k, i in events if k == "release"}) <= 3
    (r_a, a), (r_b, b) = runs
    assert all(math.isfinite(v) for v in r_b.mean_metrics.values())
    _assert_bitwise(r_a, a, r_b, b)


def test_host_plane_actor_failure_propagates():
    class _Exploding:
        def reset(self):
            return np.zeros(8, np.float32)

        def step(self, action):
            raise RuntimeError("emulator crashed")

    with HostEnvPool([_Exploding] * 4, n_workers=2, obs_shape=(8,),
                     device="cpu") as pool:
        prl = _host_pipelined(pool, queue_depth=1, num_actors=2)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="pipeline actor") as info:
            prl.run(10)
        assert time.perf_counter() - t0 < 60.0
    assert "emulator crashed" in str(info.value.__cause__)


def test_host_act_step_logp_matches_the_log_softmax_gather():
    cfg = get_config("paac_vector").replace(obs_shape=(3,), num_actions=5)
    agent = PAACAgent(cfg, PAACConfig(t_max=2))
    act = agent.act_fn()
    params = init_policy(cfg, generator=torch.Generator().manual_seed(1),
                         device="cpu")
    obs = torch.randn(8, 3, generator=torch.Generator().manual_seed(2))
    action, value, logp = make_host_act_step(act)(
        params, obs, torch.Generator().manual_seed(0))
    logits, v = act(params, obs)
    want = torch.log_softmax(logits, -1).gather(1, action[:, None])[:, 0]
    torch.testing.assert_close(logp, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(value, v) and action.dtype == torch.int64
    replay = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2])
    again, _, logp2 = make_host_act_step(act)(params, obs, None, replay)
    assert torch.equal(again, replay)
    torch.testing.assert_close(
        logp2, torch.log_softmax(logits, -1).gather(1, replay[:, None])[:, 0],
        rtol=1e-6, atol=1e-6)


def test_only_the_learner_calls_the_kernels_on_the_host_plane(monkeypatch):
    calls = []
    for name in ("nstep_returns", "vtrace_returns"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, threading.current_thread().name))
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, spy)
    learner = threading.current_thread().name
    with _spec().build() as pool:
        ParallelRL(pool, _host_agent(), device="cpu").run(2)
        assert calls == [("nstep_returns", learner)] * 2
        calls.clear()
        _host_pipelined(pool, queue_depth=2, num_actors=2).run(4)
        assert calls == [("vtrace_returns", learner)] * 4


def test_host_plane_refusals_and_the_run_observers(tmp_path, caplog):
    with _spec().build() as pool:
        with pytest.raises(ValueError, match="born in host memory"):
            _host_pipelined(pool, rollout_plane="device")
        with pytest.raises(ValueError, match="born in host memory"):
            _host_pipelined(pool, rollout_plane="mesh")
        with pytest.raises(ValueError, match="all host or all tensor"):
            _host_pipelined([pool, _grid(8)], num_actors=2)
        with pytest.raises(NotImplementedError, match="is neither"):
            _pipelined(object())
        hb = tmp_path / "hb.jsonl"
        with caplog.at_level(logging.WARNING,
                             logger="repro_torch.telemetry"):
            prl = _host_pipelined(pool, queue_depth=2,
                                  metrics_jsonl=str(hb), heartbeat_s=0.05,
                                  stall_timeout_s=30.0)
            res = prl.run(4)
    lines = [json.loads(x) for x in hb.read_text().splitlines()]
    assert lines and lines[-1]["steps"] == res.steps == 4 * 8 * 5
    assert {"time_unix", "uptime_s", "steps_per_s_ema", "span_drops",
            "actor_last_activity_s", "counters", "queue_depth",
            "staleness"} <= set(lines[-1])
    assert set(lines[-1]["actor_last_activity_s"]) == {"actor0"}
    assert "stall watchdog" not in caplog.text
    names = {em.name for _, _, em in prl.telemetry.tracks()}
    assert names == {"learner", "queue", "actor0"}


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("setting,item", [
    (dict(rollout_plane="mesh"), "item 14"),
    (dict(mesh_shape=2), "item 14"),
    (dict(elastic=True), "item 10"),
    (dict(fault_plan=object()), "item 10"),
    (dict(checkpoint_dir="ckpt"), "item 10"),
], ids=lambda x: next(iter(x)) if isinstance(x, dict) else x)
def test_unported_settings_raise(setting, item):
    with pytest.raises(NotImplementedError, match=item):
        _pipelined(**setting)


def test_pipeline_config_validates_as_the_reference():
    for bad in (dict(mesh_shape=0), dict(heartbeat_s=0),
                dict(replay_capacity=0), dict(prioritized=True),
                dict(lease_timeout_s=0), dict(checkpoint_every=2)):
        with pytest.raises(ValueError):
            PipelineConfig(**bad)
    with pytest.raises(ValueError, match="lockstep"):
        _pipelined(lockstep=True, num_actors=2)

    class OtherAgent(PAACAgent):
        pass

    # the reference's agent checks: plain PAACAgent on the FIFO planes;
    # DQNAgent only on the replay plane
    from repro_torch.core.agents import (DQNAgent, DQNConfig,
                                         LaggedPAACAgent, PPOAgent)

    cfg = _grid_agent().cfg
    for other in (OtherAgent(cfg), LaggedPAACAgent(cfg), PPOAgent(cfg)):
        with pytest.raises(NotImplementedError, match="drives plain "
                           "PAACAgent"):
            PipelinedRL(_grid(), other, device="cpu")
    with pytest.raises(ValueError, match="needs the replay plane"):
        PipelinedRL(_grid(), DQNAgent(cfg), device="cpu")
    res = PipelinedRL(_grid(), DQNAgent(cfg, DQNConfig(t_max=2)),
                      device="cpu",
                      pipeline=PipelineConfig(replay_plane=True)).run(2)
    assert res.steps == 2 * 8 * 2 and math.isfinite(res.mean_metrics["loss"])


def test_entry_points_raise_without_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelinedRL(_grid(), _grid_agent())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_atari.main(["--iters", "1", "--n-envs", "2", "--pipeline"])
    assert RunResult(1, 0.0, {}).per_actor_idle_s == []


def test_paper_atari_pipeline_runs_on_the_cpu(capsys):
    results = paper_atari.main(["--device", "cpu", "--n-envs", "4",
                                "--iters", "2", "--arch", "paac_nature",
                                "--pipeline"])
    assert len(results) == 1 and results[0].steps == 2 * 4 * 5
    m = results[0].mean_metrics
    assert all(math.isfinite(v) for v in m.values())
    assert 0 < m["entropy"] <= math.log(3) + 1e-6
    out = capsys.readouterr().out
    assert "epoch 0: steps=     40" in out
    assert "staleness=" in out and "actor_idle=" in out \
        and "learner_idle=" in out

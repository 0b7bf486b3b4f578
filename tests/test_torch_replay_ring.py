"""The port's replay plane (CPU, small shapes).

Mirrors of ``tests/test_replay.py``'s ``ReplayRing`` contract, sampling
properties and pins, torch against torch:

* the ring mirrors ``DeviceTrajectoryRing`` where the contracts coincide
  (payloads on the ring's device — a numpy leaf, or a CPU tensor on a CUDA
  ring, is refused — close wakes a blocked consumer, producer_done drains
  then closes, constructor validation) and inverts them where replay
  demands (put never blocks: a full ring evicts FIFO by ticket; get
  samples and *retains*, one get a fresh ticket, the batch concatenated
  along the env axis with the oldest behaviour version); priorities:
  evicted tickets skipped, the positive floor, new slots at the maximum;
* sampling properties (hypothesis): uniform draws within 6σ, only resident
  slots drawn, eviction retires strictly the oldest tickets, prioritized
  frequencies track the priorities; the draw of consume index i is a pure
  function of (sample_seed, i);
* the pins: a depth-1 lockstep pipelined DQN ≡ ``SyncReplayDQN`` bitwise
  across two ``run()`` calls; replay-PAAC at capacity 1 with infinite
  clips ≡ ``ParallelRL`` bitwise, and at clips 1 (V-trace, K2's path) ≡
  the FIFO device plane's lockstep run, bitwise; finite clips on deep
  replay run off-policy; a multi-actor prioritized DQN smoke; the config
  matrix and the refusals.

Against the reference, with its draws injected: ``make_dqn_collect_fn``
with its ε-uniforms and random actions (actions, rewards, dones and obs
exact, value and logp within 1e-5); one ``make_dqn_learner_step`` on the
same rollout with bridged params (the metrics and every new parameter
and target leaf within the reference's 1e-5); the ring's concatenated
batch with the reference ring's sampled tickets, exact.
"""
import queue as stdlib_queue
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.agents import DQNAgent as JDQNAgent  # noqa: E402
from repro.core.agents import DQNConfig as JDQNConfig  # noqa: E402
from repro.core.rollout import Transition as JTransition  # noqa: E402
from repro.envs import GridWorld as JGridWorld  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.optim import make_optimizer as jax_optimizer  # noqa: E402
from repro.pipeline import ReplayRing as JReplayRing  # noqa: E402
from repro.pipeline import Rollout as JRollout  # noqa: E402
from repro.pipeline.offpolicy import (  # noqa: E402
    make_dqn_collect_fn as jax_dqn_collect)
from repro.pipeline.offpolicy import (  # noqa: E402
    make_dqn_learner_step as jax_dqn_step)
from repro_torch.configs import PipelineConfig, get_config  # noqa: E402
from repro_torch.core import ParallelRL  # noqa: E402
from repro_torch.core.agents import (DQNAgent, DQNConfig,  # noqa: E402
                                     PAACAgent)
from repro_torch.core.rollout import Transition  # noqa: E402
from repro_torch.envs import GridWorld, HostEnvPool  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.pipeline import (CLOSED, PipelinedRL,  # noqa: E402
                                  QueueClosed, ReplayRing, Rollout,
                                  SyncReplayDQN, make_dqn_collect_fn,
                                  make_dqn_learner_step)
from repro_torch.pipeline.offpolicy import DQNActDraws  # noqa: E402
from repro_torch.pipeline.replay_ring import sample_generator  # noqa: E402
from repro_torch.utils.bridge import (params_from_numpy,  # noqa: E402
                                      params_to_numpy)
from repro_torch.utils.tree import tree_leaves  # noqa: E402

hypothesis = pytest.importorskip("hypothesis")
import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

INF = float("inf")
ATOL = RTOL = 1e-5


def _t(x):
    return torch.tensor(x, dtype=torch.float32)


def _mini_rollout(tag: float, version: int = 0, seq: int = 0, E: int = 2,
                  T: int = 3) -> Rollout:
    """A tiny CPU Rollout whose tensors are filled with ``tag`` (so a
    sampled payload identifies which put produced it)."""
    traj = Transition(
        obs=torch.full((T, E, 2), tag), action=torch.zeros((T, E),
                                                           dtype=torch.int64),
        reward=torch.full((T, E), tag), done=torch.zeros((T, E), dtype=bool),
        value=torch.zeros((T, E)), logp=torch.zeros((T, E)))
    return Rollout(traj, torch.full((E, 2), tag), behavior_version=version,
                   actor_id=0, seq=seq)


def _ring(**kw):
    return ReplayRing(device="cpu", **kw)


def _grid(n=8):
    return GridWorld(n, size=4, max_steps=20, device="cpu")


def _vector_cfg(env, get=get_config):
    return get("paac_vector").replace(obs_shape=env.obs_shape,
                                      num_actions=env.num_actions)


def _same_tree(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# ---------------------------------------------------------------- contract
def test_replay_ring_put_never_blocks_and_evicts_fifo():
    ring = _ring(capacity=3)
    t0 = time.perf_counter()
    for i in range(7):
        ring.put(_t(float(i)))
    assert time.perf_counter() - t0 < 1.0  # no backpressure, ever
    assert ring.tickets_issued == 7
    assert ring.evictions == 4
    assert ring.resident == 3
    assert ring.resident_tickets() == [4, 5, 6]  # strictly the oldest went
    payloads = sorted(float(p) for p in ring.sample(sample_generator(0, 0),
                                                    64))
    assert set(payloads) <= {4.0, 5.0, 6.0}
    assert ring.put_wait_s == 0.0  # plane-parity accounting
    names = {ring.span_emitter.categories[c]
             for c, _, _ in ring.span_emitter.snapshot()}
    assert {"replay.add", "replay.evict", "replay.sample"} <= names


def test_replay_ring_rejects_payloads_off_its_device():
    ring = _ring(capacity=2)
    with pytest.raises(TypeError, match="host"):
        ring.put(np.zeros(3))
    ring.put(_t(1.0))  # tensors on its device are still fine afterwards
    assert ring.resident == 1
    # a CPU tensor on a CUDA ring: a host payload crept into the plane
    with pytest.raises(TypeError, match="ReplayRing payloads must be "
                       "tensors on the ring's device cuda"):
        ReplayRing(capacity=2, device="cuda").put(_mini_rollout(1.0))


def test_replay_ring_sample_retains_slots():
    ring = _ring(capacity=4)
    for i in range(3):
        ring.put(_t(float(i)))
    a = ring.sample(sample_generator(5, 0), 8)
    b = ring.sample(sample_generator(5, 0), 8)  # same seed -> same draw
    assert [float(x) for x in a] == [float(x) for x in b]
    assert ring.resident == 3  # nothing consumed
    assert len(ring.last_sampled) == 8
    assert set(ring.last_sampled) <= {0, 1, 2}


def test_replay_ring_sample_empty_raises():
    with pytest.raises(stdlib_queue.Empty):
        _ring(capacity=4).sample(sample_generator(0, 0))


def test_replay_ring_get_is_ticket_paced():
    """One fresh put licenses exactly one get: residency alone never feeds
    the learner loop (what keeps quotas and lockstep meaningful)."""
    ring = _ring(capacity=4, sample_seed=0)
    ring.put(_mini_rollout(1.0, version=0, seq=0))
    out = ring.get(timeout=1.0)
    assert isinstance(out, Rollout)
    assert out.actor_id == -2 and out.seq == 0 and out.release is None
    assert float(out.traj.reward[0, 0]) == 1.0
    assert ring.resident == 1  # retained, not consumed
    with pytest.raises(stdlib_queue.Empty):
        ring.get(timeout=0.05)  # resident but no fresh ticket
    ring.put(_mini_rollout(2.0, version=1, seq=1))
    out2 = ring.get(timeout=1.0)
    assert out2.seq == 1  # the consume index advances
    assert float(out2.traj.reward[0, 0]) in (1.0, 2.0)  # sampled, not FIFO


def test_replay_ring_get_batch_concat_and_min_version():
    ring = _ring(capacity=4, batch_size=3, sample_seed=7)
    ring.put(_mini_rollout(1.0, version=0, seq=0))
    ring.put(_mini_rollout(2.0, version=5, seq=1))
    ring.get(timeout=1.0)  # consume ticket 0
    out = ring.get(timeout=1.0)
    # 3 sampled rollouts of E=2 envs concatenated along the env axis
    assert out.traj.reward.shape == (3, 6)
    assert out.last_obs.shape == (6, 2)
    tags = [float(out.traj.reward[0, 2 * j]) for j in range(3)]
    assert tags == [1.0 + t for t in ring.last_sampled]
    # staleness reports the OLDEST experience in the batch
    assert out.behavior_version == min(5 * t for t in ring.last_sampled)
    # the sampled slots are retained: nothing wrote into them
    assert [float(ring._slots[t].payload.traj.reward[0, 0])
            for t in (0, 1)] == [1.0, 2.0]


def test_replay_ring_draw_is_a_function_of_seed_and_consume_index():
    def draws(seed):
        ring = _ring(capacity=8, batch_size=4, sample_seed=seed)
        out = []
        for i in range(6):
            ring.put(_mini_rollout(float(i), version=i, seq=i))
            ring.get(timeout=1.0)
            out.append(ring.last_sampled)
        return out

    assert draws(3) == draws(3)
    assert draws(3) != draws(4)
    # the idx seam replaces the draw with resident positions, oldest first
    ring = _ring(capacity=2, batch_size=2)
    for i in range(3):
        ring.put(_mini_rollout(float(i), version=i, seq=i))
    out = ring.get(timeout=1.0, idx=[1, 0])
    assert ring.last_sampled == (2, 1)
    assert out.behavior_version == 1
    with pytest.raises(IndexError):  # ticket 2 is still fresh
        ring.get(timeout=1.0, idx=[2])


def test_replay_ring_close_wakes_blocked_get():
    ring = _ring(capacity=2)
    got = []
    t = threading.Thread(target=lambda: got.append(ring.get()))
    t.start()
    time.sleep(0.1)
    ring.close()
    t.join(timeout=2.0)
    assert not t.is_alive()
    assert got == [CLOSED]


def test_replay_ring_producer_done_drains_then_closes():
    ring = _ring(capacity=4, producers=2)
    ring.put(_mini_rollout(1.0))
    ring.producer_done()
    ring.put(_mini_rollout(2.0, seq=1))  # second producer still live
    ring.producer_done()
    with pytest.raises(QueueClosed):
        ring.put(_t(3.0))  # closed to producers
    # the consumer still drains the two fresh tickets before CLOSED
    assert isinstance(ring.get(timeout=1.0), Rollout)
    assert isinstance(ring.get(timeout=1.0), Rollout)
    assert ring.get(timeout=1.0) is CLOSED
    assert ring.get(timeout=1.0) is CLOSED  # idempotent


def test_replay_ring_update_priorities_skips_evicted():
    ring = _ring(capacity=2, prioritized=True)
    for i in range(3):  # ticket 0 evicted
        ring.put(_t(float(i)))
    ring.update_priorities([0, 1, 2], [9.0, 5.0, 3.0])
    assert ring._slots[1 % 2].priority == 5.0
    assert ring._slots[2 % 2].priority == 3.0
    ring.update_priorities([1], [0.0])  # clamped to the positive floor
    assert ring._slots[1 % 2].priority == pytest.approx(1e-6)


def test_replay_ring_new_slots_enter_at_max_priority():
    ring = _ring(capacity=4, prioritized=True)
    ring.put(_t(0.0))
    ring.update_priorities([0], [10.0])
    ring.put(_t(1.0))  # fresh experience must be sampleable at least once
    assert ring._slots[1].priority == 10.0


def test_replay_ring_constructor_validation():
    for bad in (dict(capacity=0), dict(batch_size=0), dict(producers=0)):
        with pytest.raises(ValueError):
            _ring(**bad)


# ---------------------------------------------------------------- properties
@settings(deadline=None, max_examples=25)
@given(seed=st.integers(0, 2**31 - 1))
def test_uniform_sampling_is_uniform_within_bounds(seed):
    """Every resident slot's draw frequency lies within 6σ of the uniform
    expectation (binomial bound)."""
    n, draws = 8, 4096
    ring = _ring(capacity=n)
    for i in range(n):
        ring.put(_t(float(i)))
    ring.sample(sample_generator(seed, 0), draws)
    counts = np.bincount(np.asarray(ring.last_sampled), minlength=n)
    p = 1.0 / n
    sigma = (draws * p * (1 - p)) ** 0.5
    assert (abs(counts - draws * p) <= 6 * sigma).all(), counts


@settings(deadline=None, max_examples=25)
@given(capacity=st.integers(2, 16), n_puts=st.integers(1, 15),
       seed=st.integers(0, 2**31 - 1))
def test_only_resident_slots_sampled_when_partially_filled(capacity, n_puts,
                                                           seed):
    ring = _ring(capacity=capacity)
    for i in range(n_puts):
        ring.put(_t(float(i)))
    vals = ring.sample(sample_generator(seed, 0), 64)
    live = set(ring.resident_tickets())
    assert set(ring.last_sampled) <= live
    assert {float(v) for v in vals} <= {float(t) for t in live}


@settings(deadline=None, max_examples=25)
@given(capacity=st.integers(1, 8), n_puts=st.integers(0, 24))
def test_eviction_retires_strictly_oldest_tickets(capacity, n_puts):
    ring = _ring(capacity=capacity)
    for i in range(n_puts):
        ring.put(_t(float(i)))
    expect_evicted = max(0, n_puts - capacity)
    assert ring.evictions == expect_evicted
    assert ring.resident_tickets() == list(range(expect_evicted, n_puts))
    assert ring.tickets_issued == n_puts


@settings(deadline=None, max_examples=25)
@given(prios=st.lists(st.floats(0.1, 10.0), min_size=2, max_size=6),
       seed=st.integers(0, 2**31 - 1))
def test_prioritized_frequencies_track_priorities(prios, seed):
    """Empirical draw frequencies match p_i = prio_i / sum within 6σ."""
    n, draws = len(prios), 4096
    ring = _ring(capacity=n, prioritized=True)
    for i in range(n):
        ring.put(_t(float(i)))
    ring.update_priorities(list(range(n)), prios)
    ring.sample(sample_generator(seed, 0), draws)
    counts = np.bincount(np.asarray(ring.last_sampled), minlength=n)
    p = np.asarray(prios) / sum(prios)
    sigma = np.sqrt(draws * p * (1 - p))
    assert (np.abs(counts - draws * p) <= 6 * sigma + 1).all(), counts


# ---------------------------------------------------------------- pins
def _replay_pipe(env, agent, seed, **kw):
    return PipelinedRL(env, agent, lr_schedule=constant(0.01), seed=seed,
                       device="cpu",
                       pipeline=PipelineConfig(replay_plane=True, **kw))


def test_replay_depth1_lockstep_dqn_bitwise_vs_sync():
    """A depth-1 lockstep pipelined replay-DQN reproduces the serial
    SyncReplayDQN bit for bit — the same collect, ring seed and learner
    step — across repeated run() calls (the ε index and the generators
    persist). DQN launches no kernel."""
    agent = DQNAgent(_vector_cfg(_grid()),
                     DQNConfig(t_max=4, eps_steps=50, target_sync=5))
    sync = SyncReplayDQN(_grid(), agent, lr_schedule=constant(0.01), seed=3,
                         replay_capacity=4, replay_batch=1, device="cpu")
    pipe = _replay_pipe(_grid(), agent, 3, queue_depth=1, lockstep=True,
                        replay_capacity=4, replay_batch=1)
    ops.reset_launches()
    r1, r2 = sync.run(10), pipe.run(10)
    assert not any(ops.launches.values())
    assert _same_tree(sync.params, pipe.params)
    assert _same_tree(sync._target, pipe._target)
    assert sync._updates == pipe._updates == 10
    assert torch.equal(sync.act_generator.get_state(),
                       pipe._actor_keys[0][0].get_state())
    for k, v in r1.mean_metrics.items():
        assert r2.mean_metrics[k] == v, k
    # a sample reaches back at most capacity - 1 rollouts
    assert max(pipe.staleness) <= 3 and min(pipe.staleness) == 0
    # continuation run stays bitwise (ε schedule and generators persist)
    r1, r2 = sync.run(5), pipe.run(5)
    assert _same_tree(sync.params, pipe.params)
    assert r1.mean_metrics["loss"] == r2.mean_metrics["loss"]
    assert pipe._actor_seq == [15] and sync._rollouts == 15
    # the hub kept on the backend holds the ring's last depth, not the
    # ring (whose resident rollouts would outlive the run)
    assert pipe.telemetry.gauges()["queue_depth"] == 0


def test_replay_paac_staleness0_equals_onpolicy_bitwise():
    """At capacity 1 / batch 1 / lockstep the ring always samples the
    rollout just produced: with infinite clips the run is ParallelRL's
    (n-step, K1), and at clips 1 (V-trace, K2) the FIFO device plane's
    lockstep run, both bit for bit."""
    agent = PAACAgent(_vector_cfg(_grid()))
    ref = ParallelRL(_grid(), agent, lr_schedule=constant(0.01), seed=1,
                     device="cpu")
    pipe = _replay_pipe(_grid(), agent, 1, queue_depth=1, lockstep=True,
                        rho_bar=INF, c_bar=INF, replay_capacity=1)
    r1, r2 = ref.run(10), pipe.run(10)
    assert _same_tree(ref.params, pipe.params)
    for k, v in r1.mean_metrics.items():
        assert r2.mean_metrics[k] == v, k
    fifo = PipelinedRL(_grid(), agent, lr_schedule=constant(0.01), seed=1,
                       device="cpu",
                       pipeline=PipelineConfig(queue_depth=1, lockstep=True))
    pipe = _replay_pipe(_grid(), agent, 1, queue_depth=1, lockstep=True,
                        replay_capacity=1)
    calls = []
    real = ops.vtrace_returns
    ops.vtrace_returns = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        r1, r2 = fifo.run(8), pipe.run(8)
    finally:
        ops.vtrace_returns = real
    assert len(calls) == 16  # K2 once an update on both planes
    assert _same_tree(fifo.params, pipe.params)
    assert r1.mean_metrics == r2.mean_metrics


def test_replay_paac_finite_clips_corrects_stale_rollouts():
    """Off-policy PAAC end to end: deep replay (staleness >> 1) under the
    default finite V-trace clips runs and reports the stale regime."""
    agent = PAACAgent(_vector_cfg(_grid()))
    pipe = _replay_pipe(_grid(), agent, 1, num_actors=2, replay_capacity=16,
                        replay_batch=2)
    res = pipe.run(20)
    assert res.steps == 20 * 4 * agent.hp.t_max  # 2 actors x 4-env shards
    assert res.mean_metrics["staleness"] > 1.0  # genuinely off-policy
    assert np.isfinite(res.mean_metrics["loss"])
    assert sorted(pipe.learned_ids) == [(-2, s) for s in range(20)]


def test_replay_multiactor_prioritized_dqn_smoke():
    agent = DQNAgent(_vector_cfg(_grid()),
                     DQNConfig(t_max=4, eps_steps=100, target_sync=5))
    pipe = _replay_pipe(_grid(), agent, 7, num_actors=2, replay_capacity=8,
                        replay_batch=2, prioritized=True)
    res = pipe.run(12)
    assert res.steps == 12 * 4 * agent.hp.t_max
    assert np.isfinite(res.mean_metrics["loss"])
    assert res.mean_metrics["q_mean"] != 0.0
    assert pipe._actor_seq == [6, 6]


def test_replay_config_matrix_validation():
    with pytest.raises(ValueError, match="prioritized"):
        PipelineConfig(prioritized=True)
    with pytest.raises(ValueError, match="replay_capacity"):
        PipelineConfig(replay_capacity=0)
    with pytest.raises(ValueError, match="replay_batch"):
        PipelineConfig(replay_batch=0)
    with pytest.raises(ValueError, match="thread"):
        PipelineConfig(replay_plane=True, actor_backend="process")
    with pytest.raises(ValueError, match="mesh"):
        PipelineConfig(replay_plane=True, mesh_shape=2)
    with pytest.raises(ValueError, match="device plane"):
        PipelineConfig(replay_plane=True, rollout_plane="host")
    PipelineConfig(replay_plane=True)  # the valid cells construct fine
    PipelineConfig(replay_plane=True, rollout_plane="device",
                   replay_capacity=128, replay_batch=4, prioritized=True)


def test_dqn_requires_replay_plane():
    agent = DQNAgent(_vector_cfg(_grid()), DQNConfig(t_max=4))
    with pytest.raises(ValueError, match="replay"):
        PipelinedRL(_grid(), agent, lr_schedule=constant(0.01), device="cpu",
                    pipeline=PipelineConfig())


def test_replay_rejects_host_envs():
    class _E:
        def reset(self):
            return np.zeros(3, np.float32)

        def step(self, a):
            return np.zeros(3, np.float32), 0.0, False, {}

    agent = PAACAgent(_vector_cfg(_grid()))
    with HostEnvPool([_E for _ in range(4)], obs_shape=(3,),
                     device="cpu") as pool:
        with pytest.raises(ValueError, match="device plane"):
            PipelinedRL(pool, agent, lr_schedule=constant(0.01),
                        device="cpu",
                        pipeline=PipelineConfig(replay_plane=True))


# ---------------------------------------------------------------- reference
N, T, SIZE = 8, 4, 8


def _far_state(rng):
    """GridWorld states whose goal is out of reach within T moves and whose
    clock is far from the limit: no env resets, so no env draws."""
    lo, hi = rng.integers(0, 2, (N, 2)), rng.integers(SIZE - 2, SIZE, (N, 2))
    return {"pos": lo.astype(np.int32), "goal": hi.astype(np.int32),
            "t": np.zeros(N, np.int32)}


def _bridged_pair(cfg_j, seed):
    pj = jax_init(jax.random.PRNGKey(seed), cfg_j)
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                 "cpu")


@pytest.fixture(scope="module")
def dqn_rollout():
    """The reference's ε-greedy collect (ε mid-schedule) and its draws,
    then the port's with those draws injected."""
    env, env_j = (GridWorld(N, size=SIZE, max_steps=20, device="cpu"),
                  JGridWorld(N, size=SIZE, max_steps=20))
    hp = dict(t_max=T, eps_steps=10, target_sync=5)
    agent_j = JDQNAgent(_vector_cfg(env_j, jax_config), JDQNConfig(**hp))
    agent = DQNAgent(_vector_cfg(env), DQNConfig(**hp))
    pj, pt = _bridged_pair(agent_j.cfg, 3)
    state = _far_state(np.random.default_rng(4))
    key, idx = jax.random.PRNGKey(9), 5
    collect_j = jax.jit(jax_dqn_collect(agent_j, env_j, T))
    state_j = jax.tree_util.tree_map(jnp.asarray, state)
    _, last_j, _, traj_j = collect_j(pj, state_j, env_j.observe(state_j), key,
                                     jnp.asarray(idx, jnp.int32))
    k, us, rands = key, [], []
    for _ in range(T):  # the reference's key walk inside the collect
        k, k_eps, k_act, _ = jax.random.split(k, 4)
        us.append(np.asarray(jax.random.uniform(k_eps, (N,))))
        rands.append(np.asarray(jax.random.randint(k_act, (N,), 0, 4)))
    draws = DQNActDraws(torch.from_numpy(np.stack(us)),
                        torch.from_numpy(np.stack(rands)))
    state_t = {k: torch.from_numpy(v) for k, v in state.items()}
    g = torch.Generator().manual_seed(0)
    _, last_t, traj_t = make_dqn_collect_fn(agent, env, T)(
        pt, state_t, env.observe(state_t), g, g, idx, draws=draws)
    return dict(agent_j=agent_j, agent=agent, pj=pj, pt=pt, traj_j=traj_j,
                last_j=last_j, traj_t=traj_t, last_t=last_t,
                explore=np.stack(us) < float(agent.epsilon(idx)))


def test_dqn_collect_matches_the_reference_with_its_draws(dqn_rollout):
    r = dqn_rollout
    assert r["explore"].any() and not r["explore"].all()
    tj, tt = r["traj_j"], r["traj_t"]
    assert not np.asarray(tj.done).any()
    for f in ("obs", "action", "reward", "done"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)), err_msg=f)
    for f in ("value", "logp"):
        np.testing.assert_allclose(getattr(tt, f).numpy(),
                                   np.asarray(getattr(tj, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(r["last_t"].numpy(), np.asarray(r["last_j"]))
    assert tt.action.dtype == torch.int64


def test_dqn_learner_step_matches_the_reference(dqn_rollout):
    """One replay-fed TD update on the reference's rollout: the metrics,
    every new parameter and the target, hard-synced at the fifth update."""
    r = dqn_rollout
    lr = 0.01
    tj_params, tt_params = _bridged_pair(r["agent_j"].cfg, 4)
    opt_j, opt = jax_optimizer("rmsprop"), make_optimizer("rmsprop")
    step_j = jax.jit(jax_dqn_step(r["agent_j"], opt_j, jconstant(lr)))
    for updates in (0, 4):  # a held target, then the hard sync
        new_j, _, tgt_j, upd_j, m_j = step_j(
            r["pj"], opt_j.init(r["pj"]), tj_params,
            jnp.asarray(updates, jnp.int32), r["traj_j"], r["last_j"],
            jnp.asarray(2, jnp.int32))
        traj = Transition(*(torch.from_numpy(np.array(a)) for a in r["traj_j"]))
        new_t, _, tgt_t, upd_t, m_t = make_dqn_learner_step(
            r["agent"], opt, constant(lr))(
            r["pt"], opt.init(r["pt"]), tt_params, updates, traj,
            torch.from_numpy(np.array(r["last_j"])), 2)
        assert upd_t == int(upd_j) == updates + 1
        for k in ("loss", "q_mean", "td_abs", "reward_sum", "episodes"):
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        for tree_t, tree_j in ((new_t, new_j), (tgt_t, tgt_j)):
            for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(tree_t)),
                            jax.tree_util.tree_leaves(tree_j)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL,
                                           atol=ATOL)
        assert (tgt_t is new_t) == (updates == 4)


def test_ring_batch_matches_the_reference_with_its_draws():
    """Five tagged rollouts through a capacity-3 ring (two evicted), three
    gets of a batch of 3: the reference's sampled tickets, replayed as
    resident positions, give the same concatenated batch and version."""
    E, Tm = 2, 3
    rng = np.random.default_rng(11)
    ring_j = JReplayRing(capacity=3, batch_size=3, sample_seed=5)
    ring_t = _ring(capacity=3, batch_size=3, sample_seed=5)
    fields = ("obs", "action", "reward", "done", "value", "logp")
    for i in range(5):
        arrays = dict(obs=rng.normal(size=(Tm, E, 2)).astype(np.float32),
                      action=rng.integers(0, 4, (Tm, E)),
                      reward=rng.normal(size=(Tm, E)).astype(np.float32),
                      done=rng.random((Tm, E)) < 0.3,
                      value=rng.normal(size=(Tm, E)).astype(np.float32),
                      logp=rng.normal(size=(Tm, E)).astype(np.float32))
        last = rng.normal(size=(E, 2)).astype(np.float32)
        ring_j.put(JRollout(JTransition(**{f: jnp.asarray(a) for f, a in
                                           arrays.items()}),
                            jnp.asarray(last), behavior_version=i, seq=i))
        ring_t.put(Rollout(Transition(**{f: torch.from_numpy(a) for f, a in
                                         arrays.items()}),
                           torch.from_numpy(last), behavior_version=i, seq=i))
        if i >= 2:
            out_j = ring_j.get(timeout=1.0)
            idx = [t - ring_j.resident_tickets()[0]
                   for t in ring_j.last_sampled]
            out_t = ring_t.get(timeout=1.0, idx=idx)
            assert ring_t.last_sampled == ring_j.last_sampled
            assert (out_t.behavior_version, out_t.seq, out_t.actor_id) == (
                out_j.behavior_version, out_j.seq, out_j.actor_id)
            for f in fields:
                np.testing.assert_array_equal(
                    getattr(out_t.traj, f).numpy(),
                    np.asarray(getattr(out_j.traj, f)), err_msg=f)
            np.testing.assert_array_equal(out_t.last_obs.numpy(),
                                          np.asarray(out_j.last_obs))
    assert ring_t.evictions == ring_j.evictions == 2

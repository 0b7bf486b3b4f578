"""The port's host env plane against the JAX package's (CPU, small shapes).

The same seeds and numpy inputs go through ``repro`` and ``repro_torch``:

* ``PyBoundEnv``, a ``HostEnvPool`` of them, its ``reset``, a
  ``shard(2)`` and ``HostEnvSpec.shard``'s split, stepped with the same
  seeded actions — exact (both keep the numpy ``RandomState``);
* ``collect_host``: the reference's, with its jitted act step, records its
  actions; the port's replays them on bridged params — obs, action,
  reward and done exact, value and logp within 1e-5;
* one host-branch update (the learner step at ρ̄ = c̄ = ∞, as both
  ``ParallelRL``s run it) on that trajectory — loss within rtol 1e-4 atol
  1e-5 and every new parameter within the same (``tests/test_torch_rl.py``);
* the telemetry hub's heartbeat writes the reference's keys, and the
  watchdog names the blocked stage and stays quiet while progress flows.

Torch against torch, mirrors of ``tests/test_host_env.py``: parallel
stepping and reset, shared buffers, snapshots that never alias, shards,
``obs_dtype``, the loud closed-pool error, the spec building an equivalent
pool, pickling and the refusal of closures, idempotent close. The pool,
the spec and ``ParallelRL`` on a pool raise without a card unless the CPU
is asked for.
"""
import json
import logging
import pickle
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
from repro.envs import PyBoundEnv as JPyBoundEnv  # noqa: E402
from repro.envs import py_bound_spec as jax_spec  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import make_optimizer as jax_optimizer  # noqa: E402
from repro.pipeline.actor import collect_host as jax_collect  # noqa: E402
from repro.pipeline.actor import make_host_act_step as jax_act  # noqa: E402
from repro.pipeline.learner import (  # noqa: E402
    make_learner_step as jax_learner_step)
from repro.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ParallelRL  # noqa: E402
from repro_torch.core.agents import PAACAgent, PAACConfig  # noqa: E402
from repro_torch.envs import (HostEnvPool, HostEnvSpec,  # noqa: E402
                              PyBoundEnv, py_bound_spec)
from repro_torch.envs.pyemu import make_py_bound_env  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.pipeline import collect_host, make_host_act_step  # noqa: E402
from repro_torch.pipeline.actor import to_device  # noqa: E402
from repro_torch.pipeline.learner import make_learner_step  # noqa: E402
from repro_torch.telemetry import (COLLECT, QUEUE_GET_WAIT,  # noqa: E402
                                   Telemetry)
from repro_torch.utils.bridge import (params_from_numpy,  # noqa: E402
                                      params_to_numpy)

INF = float("inf")


class _ToyEnv:
    """Gym-style counter env: reward 1 when action == state % 3."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.state = 0

    def reset(self):
        self.state = int(self.rng.randint(0, 100))
        return np.array([self.state], np.float32)

    def step(self, action):
        reward = 1.0 if action == self.state % 3 else 0.0
        self.state += 1
        done = self.state % 10 == 0
        return np.array([self.state], np.float32), reward, done, {}


def _toy(n, n_workers=2):
    return HostEnvPool([lambda s=i: _ToyEnv(s) for i in range(n)],
                       n_workers=n_workers, obs_shape=(1,), device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ env parity
def test_py_bound_env_matches_the_reference_exactly():
    rng = np.random.default_rng(0)
    for seed, spin in ((0, 0), (7, 50)):
        a, b = JPyBoundEnv(seed, obs_dim=5, spin=spin), PyBoundEnv(seed, 5,
                                                                  spin)
        np.testing.assert_array_equal(b.reset(), a.reset())
        for action in rng.integers(0, 3, 40):
            got, want = b.step(action), a.step(action)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]


def test_pool_reset_step_and_shards_match_the_reference_exactly():
    """The same spec through both packages' pools: reset, 25 steps of the
    same seeded actions (dones and auto-resets included), then a second
    pool's shard(2) the same way."""
    n, rng = 8, np.random.default_rng(1)
    spec_j = jax_spec(n, obs_dim=3, spin=0, n_workers=3, base_seed=4)
    spec_t = py_bound_spec(n, obs_dim=3, spin=0, n_workers=3, base_seed=4,
                           device="cpu")
    assert spec_t.env_args == spec_j.env_args
    with spec_j.build() as pj, spec_t.build() as pt:
        np.testing.assert_array_equal(_np(pt.reset()), _np(pj.reset()))
        dones = 0
        for _ in range(25):
            actions = rng.integers(0, 3, n)
            for got, want in zip(pt.step(actions), pj.step(actions)):
                np.testing.assert_array_equal(_np(got), _np(want))
            dones += int(pt._done.sum())
        assert dones > 0  # auto-resets were exercised
    with spec_j.build() as pj, spec_t.build() as pt:
        for sj, st in zip(pj.shard(2), pt.shard(2)):
            assert st.n_envs == sj.n_envs == 4
            assert len(st._slices) == len(sj._slices)
            np.testing.assert_array_equal(_np(st.reset()), _np(sj.reset()))
            for _ in range(12):
                actions = rng.integers(0, 3, 4)
                for got, want in zip(st.step_host(actions),
                                     sj.step_host(actions)):
                    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,n_workers,shards", [(8, 4, 2), (12, 5, 3),
                                                (6, 8, 6)])
def test_spec_shard_splits_envs_and_workers_as_the_reference(n, n_workers,
                                                             shards):
    js = jax_spec(n, n_workers=n_workers).shard(shards)
    ts = py_bound_spec(n, n_workers=n_workers, device="cpu").shard(shards)
    assert [s.env_args for s in ts] == [s.env_args for s in js]
    assert [s.n_workers for s in ts] == [s.n_workers for s in js]
    assert all(s.device == "cpu" for s in ts)


# ------------------------------------------------------------ collect parity
def _agents(obs_dim=4, actions=3, t_max=5):
    cfg_j = jax_config("paac_vector").replace(obs_shape=(obs_dim,),
                                              num_actions=actions)
    cfg = get_config("paac_vector").replace(obs_shape=(obs_dim,),
                                            num_actions=actions)
    return (JPAACAgent(cfg_j, JPAACConfig(t_max=t_max)),
            PAACAgent(cfg, PAACConfig(t_max=t_max)))


@pytest.fixture(scope="module")
def collected():
    """The reference's collect_host on a 6-env pool (its jitted act step,
    its draws), and the port's on the same recipe with those actions
    replayed on the bridged params."""
    agent_j, agent = _agents()
    pj = jax_init(jax.random.PRNGKey(5), agent_j.cfg)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    spec_j = jax_spec(6, obs_dim=4, n_workers=2, base_seed=3)
    spec_t = py_bound_spec(6, obs_dim=4, n_workers=2, base_seed=3,
                           device="cpu")
    with spec_j.build() as pool_j, spec_t.build() as pool_t:
        obs_j, obs_t = pool_j.reset(), pool_t.reset()
        trajs = []
        for _ in range(2):  # the second rollout carries the first's obs
            obs_j, _, tj, last_j = jax_collect(
                jax_act(agent_j.act_fn()), pool_j, pj, obs_j,
                jax.random.PRNGKey(len(trajs)), 5)
            tj = jax.tree_util.tree_map(np.array, tj)
            obs_t, tt, last_t = collect_host(
                make_host_act_step(agent.act_fn()), pool_t, pt, obs_t,
                torch.Generator().manual_seed(0), 5, actions=tj.action)
            trajs.append((tj, np.array(last_j), tt, last_t))
    return agent_j, agent, pj, pt, trajs


def test_collect_host_matches_the_reference(collected):
    *_, trajs = collected
    for tj, last_j, tt, last_t in trajs:
        for f in ("obs", "action", "reward", "done"):
            np.testing.assert_array_equal(_np(getattr(tt, f)),
                                          getattr(tj, f), err_msg=f)
        np.testing.assert_array_equal(last_t.numpy(), last_j)
        for f in ("value", "logp"):
            np.testing.assert_allclose(_np(getattr(tt, f)), getattr(tj, f),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
        assert tt.action.dtype == torch.int64 and tt.done.dtype == torch.bool
    assert any(tj.done.any() for tj, *_ in trajs)


def test_host_branch_update_matches_the_reference(collected):
    """The update both ParallelRLs run on a host pool: the learner step at
    infinite clips (K1's n-step returns; K2 never)."""
    agent_j, agent, pj, pt, trajs = collected
    tj, last_j, tt, last_t = trajs[1]
    opt_j, lr = jax_optimizer("rmsprop"), 0.003
    step_j = jax.jit(jax_learner_step(agent_j, opt_j, jax_constant(lr),
                                      rho_bar=INF, c_bar=INF))
    new_j, _, m_j = step_j(pj, opt_j.init(pj),
                           jax.tree_util.tree_map(jnp.asarray, tj),
                           jnp.asarray(last_j), jnp.int32(0))
    opt = make_optimizer("rmsprop")
    step = make_learner_step(agent, opt, constant(lr), rho_bar=INF,
                             c_bar=INF)
    traj, last_obs = to_device(tt, last_t, "cpu")
    new_t, _, m_t = step(pt, opt.init(pt), traj, last_obs, 0)
    for k in ("loss", "policy_loss", "value_loss", "entropy", "rho_mean",
              "reward_sum", "episodes"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(new_t)),
                    jax.tree_util.tree_leaves(new_j)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ mirrors
def test_host_env_pool_steps_in_parallel():
    n = 12
    pool = HostEnvPool([lambda s=i: _ToyEnv(s) for i in range(n)],
                       n_workers=4, obs_shape=(1,), device="cpu")
    obs = pool.reset()
    assert isinstance(obs, torch.Tensor) and obs.shape == (n, 1)
    actions = obs[:, 0].long() % 3  # always-correct actions
    obs2, rewards, dones = pool.step(actions.numpy())
    assert rewards.shape == (n,) and rewards.dtype == torch.float32
    assert float(rewards.min()) == 1.0  # every env rewarded
    assert dones.dtype == torch.bool
    pool.close()


def test_host_env_pool_parallel_reset_covers_all_envs():
    n = 10
    pool = HostEnvPool([lambda s=i: _ToyEnv(s) for i in range(n)],
                       n_workers=3, obs_shape=(1,), device="cpu")
    obs = pool.reset().numpy()
    expect = np.array([[_ToyEnv(i).reset()[0]] for i in range(n)])
    np.testing.assert_array_equal(obs, expect)
    pool.close()


def test_host_env_pool_step_host_returns_shared_buffers():
    n = 4
    with _toy(n) as pool:
        pool.reset()
        obs, rewards, dones = pool.step_host(np.zeros((n,), np.int64))
        assert isinstance(obs, np.ndarray) and obs.shape == (n, 1)
        assert rewards.dtype == np.float32 and dones.dtype == bool
        assert obs is pool._obs  # the shared buffer itself, not a copy
        again = pool.step_host(np.zeros((n,), np.int64))
        assert again[0] is obs


def test_host_env_tensor_outputs_never_alias_shared_buffers():
    """``reset``/``step`` snapshot the shared buffers: torch.from_numpy
    would share their memory, and the workers' writes on later steps would
    silently change an observation already returned."""
    n = 6
    with _toy(n) as pool:
        obs0 = pool.reset()
        snap0 = obs0.clone()
        obs1, r1, d1 = pool.step(np.zeros((n,), np.int64))
        snaps = [t.clone() for t in (obs1, r1, d1)]
        pool.step(np.ones((n,), np.int64))
        pool.step_host(np.ones((n,), np.int64))
        assert torch.equal(obs0, snap0)
        assert all(torch.equal(a, b) for a, b in zip((obs1, r1, d1), snaps))
        assert not np.shares_memory(obs1.numpy(), pool._obs)
    with _toy(n) as pool:  # shards snapshot too
        shard = pool.shard(2)[0]
        obs0 = shard.reset()
        snap0 = obs0.clone()
        shard.step(np.zeros((shard.n_envs,), np.int64))
        assert torch.equal(obs0, snap0)


def test_host_env_pool_shard_partitions_env_axis():
    n = 8
    with _toy(n, n_workers=4) as pool:
        shards = pool.shard(4)
        assert [s.n_envs for s in shards] == [2, 2, 2, 2]
        assert all(s.device == pool.device for s in shards)
        obs = np.concatenate([s.reset().numpy() for s in shards])
        expect = np.array([[_ToyEnv(i).reset()[0]] for i in range(n)])
        np.testing.assert_array_equal(obs, expect)
        before = [e.state for e in shards[0].envs]
        shards[1].step_host(np.zeros((2,), np.int64))
        assert [e.state for e in shards[0].envs] == before
        with pytest.raises(ValueError):
            pool.shard(3)


def test_host_env_obs_dtype_property():
    with _toy(4) as pool:
        assert pool.obs_dtype == np.float32
        assert pool.shard(2)[0].obs_dtype == np.float32
    with HostEnvPool([lambda: _ToyEnv(0)], obs_shape=(1,), obs_dtype=np.int32,
                     device="cpu") as pool:
        assert pool.obs_dtype == np.int32
        assert pool.reset().dtype == torch.int32


def test_stepping_closed_pool_raises_diagnosable_error():
    n = 4
    pool = _toy(n)
    pool.reset()
    shard = pool.shard(2)[0]
    shard.reset()
    pool.close()
    with pytest.raises(RuntimeError, match="closed env pool"):
        pool.step_host(np.zeros((n,), np.int64))
    with pytest.raises(RuntimeError, match="closed env pool"):
        pool.reset()
    with pytest.raises(RuntimeError, match="closed env pool"):
        pool.step(np.zeros((n,), np.int64))
    with pytest.raises(RuntimeError, match="closed env pool"):
        shard.step_host(np.zeros((shard.n_envs,), np.int64))
    with pytest.raises(RuntimeError, match="closed env pool"):
        shard.reset()
    with pytest.raises(RuntimeError, match="closed"):
        pool.shard(2)


def test_host_env_spec_builds_equivalent_pool():
    spec = HostEnvSpec(env_fn=make_py_bound_env,
                       env_args=tuple((i, 3, 0) for i in range(6)),
                       n_workers=2, obs_shape=(3,), obs_dtype=np.float32,
                       device="cpu")
    assert spec.n_envs == 6
    with spec.build() as pool:
        assert pool.n_workers == 2 and pool.device == torch.device("cpu")
        obs = pool.reset().numpy()
        assert obs.shape == (6, 3)
        expect = np.array([make_py_bound_env(i, 3, 0).reset()
                           for i in range(6)])
        np.testing.assert_array_equal(obs, expect)


def test_host_env_spec_shard_partitions_args_and_workers():
    spec = HostEnvSpec(env_fn=make_py_bound_env,
                       env_args=tuple((i, 2, 0) for i in range(8)),
                       n_workers=4, obs_shape=(2,), device="cpu")
    shards = spec.shard(2)
    assert [s.n_envs for s in shards] == [4, 4]
    assert shards[0].env_args == spec.env_args[:4]
    assert shards[1].env_args == spec.env_args[4:]
    assert all(s.n_workers == 2 for s in shards)
    with pytest.raises(ValueError):
        spec.shard(3)


def test_host_env_spec_pickles_and_rejects_closures():
    good = HostEnvSpec(env_fn=make_py_bound_env, env_args=((0, 2, 0),),
                       obs_shape=(2,), device="cpu")
    good.validate_picklable()
    rebuilt = pickle.loads(pickle.dumps(good))
    assert rebuilt.env_args == good.env_args and rebuilt.device == "cpu"
    bad = HostEnvSpec(env_fn=lambda s: _ToyEnv(s), env_args=((0,),),
                      obs_shape=(1,))
    with pytest.raises(ValueError, match="module-level"):
        bad.validate_picklable()


def test_host_env_pool_context_manager_and_idempotent_close():
    closed = []

    class ClosableEnv(_ToyEnv):
        def close(self):
            closed.append(id(self))

    with HostEnvPool([lambda s=i: ClosableEnv(s) for i in range(4)],
                     n_workers=2, obs_shape=(1,), device="cpu") as pool:
        pool.reset()
    assert len(closed) == 4
    pool.close()  # second close is a no-op
    assert len(closed) == 4


def test_sync_parallel_rl_drives_a_host_pool_and_refuses_other_agents():
    _, agent = _agents(obs_dim=3)
    with py_bound_spec(8, obs_dim=3, device="cpu").build() as pool:
        rl = ParallelRL(pool, agent, lr_schedule=constant(0.003), seed=0,
                        device="cpu")
        res = rl.run(6)
        assert res.steps == 6 * 8 * 5
        assert np.isfinite(res.mean_metrics["loss"]) and res.episodes > 0
        # on-policy: the importance ratios stay 1
        np.testing.assert_allclose(res.mean_metrics["rho_mean"], 1.0,
                                   atol=1e-3)
        from repro_torch.core.agents import LaggedPAACAgent, PPOAgent

        for other in (LaggedPAACAgent(agent.cfg), PPOAgent(agent.cfg)):
            with pytest.raises(NotImplementedError,
                               match="currently drives plain PAACAgent"):
                ParallelRL(pool, other, device="cpu")


def test_host_plane_raises_without_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HostEnvPool([lambda: _ToyEnv(0)], obs_shape=(1,))
    spec = py_bound_spec(2)
    assert spec.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.build()
    _, agent = _agents(obs_dim=8)
    with py_bound_spec(2, device="cpu").build() as pool:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ParallelRL(pool, agent)
        with pytest.raises(ValueError, match="env lives on cpu"):
            ParallelRL(pool, agent, device="meta")


# ------------------------------------------------------------ telemetry
def _heartbeat_lines(hub_cls, path, counter_name="steps"):
    hub = hub_cls()
    em = hub.emitter("actor0")
    em.record(COLLECT, hub.t0, hub.t0 + 0.01)
    hub.counter_add(counter_name, 64)
    hub.counter_add("fault.detect", 1)
    hub.set_gauge("queue_depth", lambda: 3)
    hub.set_gauge("staleness", 1.0)
    hub.set_gauge("broken", lambda: 1 / 0)  # must never kill the heartbeat
    hub.heartbeat_start(str(path), interval=0.05, actor_emitters=[em])
    time.sleep(0.2)
    hub.stop()  # writes one final line on the way out
    return [json.loads(line) for line in open(path) if line.strip()]


def test_heartbeat_writes_the_references_schema(tmp_path):
    ours = _heartbeat_lines(Telemetry, tmp_path / "port.jsonl")
    ref = _heartbeat_lines(JTelemetry, tmp_path / "ref.jsonl")
    assert ours and ref
    assert {frozenset(line) for line in ours} == {frozenset(ref[0])}
    for line in ours:
        assert line["queue_depth"] == 3 and line["staleness"] == 1.0
        assert line["broken"] is None
        assert line["actor_last_activity_s"]["actor0"] is not None
        assert line["counters"] == {"fault.detect": 1}
    assert ours[-1]["steps"] == 64
    hub = Telemetry()
    hub.heartbeat_start(str(tmp_path / "x.jsonl"), interval=5.0)
    try:
        with pytest.raises(RuntimeError, match="already running"):
            hub.heartbeat_start(str(tmp_path / "x.jsonl"))
    finally:
        hub.stop()


def test_watchdog_names_the_blocked_stage(caplog):
    hub = Telemetry()
    learner = hub.emitter("learner")
    actor = hub.emitter("actor0")
    learner.begin(QUEUE_GET_WAIT)  # stuck waiting, recording nothing
    with caplog.at_level(logging.WARNING, logger="repro_torch.telemetry"):
        hub.watchdog_start(0.2, [("learner", learner, None),
                                 ("actor0", actor, lambda: False)])
        time.sleep(0.6)
        hub.stop()
    learner.end()
    text = caplog.text
    assert "stall watchdog" in text
    assert "learner: blocked in queue.get_wait" in text
    assert "actor0: exited" in text
    # one report per stall episode, not one per poll tick
    assert text.count("stall watchdog") == 1
    with pytest.raises(ValueError, match="window"):
        hub.watchdog_start(0.0, [])


def test_watchdog_stays_quiet_while_progress_flows(caplog):
    hub = Telemetry()
    em = hub.emitter("learner")
    stop = threading.Event()

    def ticker():
        while not stop.is_set():
            em.record(COLLECT, time.perf_counter() - 1e-4)
            time.sleep(0.02)

    t = threading.Thread(target=ticker, daemon=True)
    t.start()
    with caplog.at_level(logging.WARNING, logger="repro_torch.telemetry"):
        hub.watchdog_start(0.15, [("learner", em, None)])
        time.sleep(0.5)
        hub.stop()
    stop.set()
    t.join(timeout=2.0)
    assert not t.is_alive()
    assert "stall watchdog" not in caplog.text

"""The port's other agents, envs and evaluation against the JAX package's
(CPU, small shapes).

The same numpy inputs go through ``repro`` and ``repro_torch``:

* ``TokenEnv`` (exact) and ``CartPole`` (within 1e-6: sin and cos may
  differ by an ulp) on one step from converted states; both keep the env
  contract of ``tests/test_envs.py`` through their auto-reset;
* ``gae_advantages`` with dones at 0%, 10% and 100% — 1e-5;
* the replay buffer: its two refusals, the wrap-around, and a sample with
  the reference's indices injected — exact;
* DQN: ``dqn_td_target`` and ``dqn_loss`` on bridged params — 1e-5; one
  whole train step with the reference's ε, action and replay draws
  injected — loss and new params within 1e-5, absolute and relative;
* lagged PAAC (``"grad"`` and ``"act"``) and PPO (4 epochs): one train
  step with the reference's actions injected — the same tolerance; the
  PPO step pins the population std (``correction=0``) of its advantage
  normalisation;
* ``evaluate`` on GridWorld with the reference's reset states injected:
  the same per-seed returns, exactly.

The trajectories of the injected steps start from GridWorld states whose
goals lie out of reach, and some rows time out on the last step: the rows
that end do so where their reset state never enters a loss, so the two
frameworks' different reset draws cannot matter.

Torch against torch: ``ParallelRL`` drives every agent and one seed gives
one run bitwise; lag 1 is PAAC bitwise; the stale copy lags; the ε
schedule and the target sync keep the reference's cadence; DQN and PPO
learn GridWorld and ``evaluate`` sees the gain of training (mirrors of
``tests/test_agents.py``, ``tests/test_extensions.py`` and
``tests/test_evaluation.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.agents import DQNAgent as JDQNAgent  # noqa: E402
from repro.core.agents import DQNConfig as JDQNConfig  # noqa: E402
from repro.core.agents import LaggedConfig as JLaggedConfig  # noqa: E402
from repro.core.agents import LaggedPAACAgent as JLaggedPAACAgent  # noqa: E402
from repro.core.agents import PAACAgent as JPAACAgent  # noqa: E402
from repro.core.agents import PPOAgent as JPPOAgent  # noqa: E402
from repro.core.agents import PPOConfig as JPPOConfig  # noqa: E402
from repro.core.agents import dqn as jdqn  # noqa: E402
from repro.core.agents import replay as jreplay  # noqa: E402
from repro.core.evaluation import evaluate as jax_evaluate  # noqa: E402
from repro.core.returns import gae_advantages as jax_gae  # noqa: E402
from repro.core.rollout import rollout as jax_rollout  # noqa: E402
from repro.envs import CartPole as JCartPole  # noqa: E402
from repro.envs import GridWorld as JGridWorld  # noqa: E402
from repro.envs import TokenEnv as JTokenEnv  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.optim import make_optimizer as jax_optimizer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ParallelRL, evaluate, gae_advantages  # noqa: E402
from repro_torch.core.agents import (DQNAgent, DQNConfig,  # noqa: E402
                                     LaggedConfig, LaggedPAACAgent,
                                     PAACAgent, PAACConfig, PPOAgent,
                                     PPOConfig)
from repro_torch.core.agents.dqn import (DQNDraws, dqn_loss,  # noqa: E402
                                         dqn_sync_target, dqn_td_target)
from repro_torch.core.agents.replay import (replay_add,  # noqa: E402
                                            replay_init, replay_nbytes,
                                            replay_sample)
from repro_torch.envs import CartPole, GridWorld, TokenEnv  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.utils.bridge import (params_from_numpy,  # noqa: E402
                                      params_to_numpy)
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ATOL, RTOL = 1e-5, 1e-5  # one train step, absolute and relative


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  _np_tree(tree))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_trees_close(got, want, *, rtol=RTOL, atol=ATOL):
    want_leaves, want_def = jax.tree_util.tree_flatten(_np_tree(want))
    got_leaves, got_def = jax.tree_util.tree_flatten(params_to_numpy(got))
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _vector_cfg(env, get=get_config):
    return get("paac_vector").replace(obs_shape=env.obs_shape,
                                      num_actions=env.num_actions)


def _bridged(env_j, seed):
    """Reference params of ``paac_vector`` for ``env_j`` and their bridge."""
    pj = jax_init(jax.random.PRNGKey(seed), _vector_cfg(env_j, jax_config))
    return pj, params_from_numpy(_np_tree(pj), "cpu")


# ---------------------------------------------------------------- envs
def test_token_env_step_matches_the_reference_exactly():
    n, vocab, ctx = 64, 16, 8
    rng = np.random.default_rng(20)
    env, env_j = (TokenEnv(n, vocab=vocab, ctx=ctx, k=2, horizon=10,
                           device="cpu"),
                  JTokenEnv(n, vocab=vocab, ctx=ctx, k=2, horizon=10))
    state = {"hist": rng.integers(0, vocab, (n, ctx)).astype(np.int32),
             "t": rng.integers(0, 10, n).astype(np.int32)}
    # half the rows play the echo, half a random token
    actions = np.where(rng.random(n) < 0.5, state["hist"][:, -2],
                       rng.integers(0, vocab, n))
    sj, rj, dj = jax.vmap(env_j._step_one)(
        _to_jax(state), jnp.asarray(actions, jnp.int32),
        jax.random.split(jax.random.PRNGKey(0), n))
    st, rt, dt = env._step_batch(_to_torch(state), torch.from_numpy(actions),
                                 torch.Generator().manual_seed(0))
    for k in ("hist", "t"):
        assert st[k].dtype == torch.int32
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert 0 < rt.sum() < n and dt.any() and not dt.all()
    np.testing.assert_array_equal(env.observe(_to_torch(state)).numpy(),
                                  np.asarray(env_j.observe(_to_jax(state))))
    assert env.obs_shape == tuple(env_j.obs_shape) == (ctx,)
    assert env.num_actions == env_j.num_actions == vocab


def test_cartpole_step_matches_the_reference():
    """One step from converted states, within 1e-6 on the state; reward and
    done exactly (the states are drawn away from the limits' edges)."""
    n = 256
    rng = np.random.default_rng(21)
    env, env_j = CartPole(n, max_steps=20, device="cpu"), JCartPole(n, 20)
    s = rng.uniform(-0.3, 0.3, (n, 4)).astype(np.float32)
    s[: n // 4, 0] = rng.choice([-2.45, 2.45], n // 4)  # past x_limit
    s[n // 4: n // 2, 2] = rng.choice([-0.25, 0.25], n // 4)  # past theta
    s[:, 1] *= 10
    s[:, 3] *= 10
    state = {"s": s, "t": rng.integers(0, 20, n).astype(np.int32)}
    actions = rng.integers(0, 2, n)
    sj, rj, dj = jax.vmap(env_j._step_one)(
        _to_jax(state), jnp.asarray(actions, jnp.int32),
        jax.random.split(jax.random.PRNGKey(0), n))
    st, rt, dt = env._step_batch(_to_torch(state), torch.from_numpy(actions),
                                 torch.Generator().manual_seed(0))
    assert st["s"].dtype == torch.float32 and st["t"].dtype == torch.int32
    np.testing.assert_allclose(st["s"].numpy(), np.asarray(sj["s"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(st["t"].numpy(), np.asarray(sj["t"]))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj, np.float32))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert dt.any() and not dt.all()
    assert np.float32(env.theta_limit) == np.float32(env_j.theta_limit)


@pytest.mark.parametrize("name", ["cartpole", "token_env"])
def test_env_contract_through_the_auto_reset(name):
    """The reference's ``test_env_contract`` (shapes, dtypes, no NaN over
    30 steps), plus: every row that ends starts afresh — t back to 0 and,
    for CartPole, a state inside the reset's [-0.05, 0.05)."""
    n = 5
    env = (CartPole(n, max_steps=20, device="cpu") if name == "cartpole"
           else TokenEnv(n, vocab=16, ctx=8, k=2, horizon=10, device="cpu"))
    g = torch.Generator().manual_seed(0)
    state = env.reset(g)
    obs = env.observe(state)
    assert obs.shape == (n,) + tuple(env.obs_shape)
    ended = 0
    for _ in range(30):
        actions = torch.randint(0, env.num_actions, (n,), generator=g)
        state, obs, reward, done = env.step(state, actions, g)
        assert obs.shape == (n,) + tuple(env.obs_shape)
        assert reward.shape == (n,) and reward.dtype == torch.float32
        assert done.shape == (n,) and done.dtype == torch.bool
        if obs.is_floating_point():
            assert not obs.isnan().any()
        assert (state["t"][done] == 0).all()
        if name == "cartpole":
            assert (state["s"][done].abs() <= 0.05).all()
        else:
            assert obs.dtype == torch.int32
            assert ((obs >= 0) & (obs < env.vocab)).all()
        ended += int(done.sum())
    assert ended > 0


# ---------------------------------------------------------------- GAE
@pytest.mark.parametrize("rate", [0.0, 0.1, 1.0])
def test_gae_matches_the_reference(rate):
    T, E = 13, 7
    rng = np.random.default_rng(int(rate * 10))
    r = rng.standard_normal((T, E)).astype(np.float32)
    d = rng.random((T, E)) < rate
    v = rng.standard_normal((T, E)).astype(np.float32)
    b = rng.standard_normal(E).astype(np.float32)
    adv_j, ret_j = jax_gae(jnp.asarray(r.T), jnp.asarray(d.T),
                           jnp.asarray(v.T), jnp.asarray(b), 0.99, 0.95)
    adv, ret = gae_advantages(torch.from_numpy(r), torch.from_numpy(d),
                              torch.from_numpy(v), torch.from_numpy(b), 0.99,
                              0.95)
    assert adv.shape == ret.shape == (T, E) and adv.dtype == torch.float32
    np.testing.assert_allclose(adv.numpy(), np.asarray(adv_j).T, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(ret_j).T, rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- replay
def _transitions(rng, E, obs_dim=3):
    return (rng.standard_normal((E, obs_dim)).astype(np.float32),
            rng.integers(0, 4, E).astype(np.int32),
            rng.standard_normal(E).astype(np.float32),
            rng.standard_normal((E, obs_dim)).astype(np.float32),
            rng.random(E) < 0.3)


def test_replay_refuses_an_overwide_batch_and_an_empty_sample():
    buf = replay_init(4, (3,), device="cpu")
    with pytest.raises(ValueError, match="exceeds capacity"):
        replay_add(buf, *map(torch.from_numpy,
                             _transitions(np.random.default_rng(0), 5)))
    assert buf["ptr"] == buf["size"] == 0
    with pytest.raises(ValueError, match="empty buffer"):
        replay_sample(buf, torch.Generator().manual_seed(0), 4)
    # exactly at capacity is fine
    replay_add(buf, *map(torch.from_numpy,
                         _transitions(np.random.default_rng(0), 4)))
    assert (buf["ptr"], buf["size"]) == (0, 4)


def test_replay_wraps_around_and_samples_the_reference_rows():
    """Three adds of 5 into a ring of 8 (the second and third wrap): the
    buffer equals the reference's, ptr and size are host ints equal to its,
    and a sample with the reference's indices equals its sample."""
    rng = np.random.default_rng(1)
    buf, buf_j = replay_init(8, (3,), device="cpu"), jreplay.replay_init(8, (3,))
    for _ in range(3):
        tr = _transitions(rng, 5)
        replay_add(buf, *map(torch.from_numpy, tr))
        buf_j = jreplay.replay_add(buf_j, *map(jnp.asarray, tr))
        assert isinstance(buf["ptr"], int) and isinstance(buf["size"], int)
        assert (buf["ptr"], buf["size"]) == (int(buf_j["ptr"]),
                                             int(buf_j["size"]))
        for k in ("obs", "action", "reward", "next_obs", "done"):
            np.testing.assert_array_equal(buf[k].numpy(), np.asarray(buf_j[k]))
    assert replay_nbytes(buf) == 8 * (2 * 3 * 4 + 4 + 4 + 1)
    key = jax.random.PRNGKey(2)
    want = jreplay.replay_sample(buf_j, key, 16)
    idx = jax.random.randint(key, (16,), 0, jnp.maximum(buf_j["size"], 1))
    got = replay_sample(buf, None, 16, idx=torch.from_numpy(np.array(idx)))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    drawn = replay_sample(buf, torch.Generator().manual_seed(3), 64)
    assert drawn["obs"].shape == (64, 3)


def test_replay_sample_draws_only_stored_rows():
    buf = replay_init(8, (2,), device="cpu")
    E = 3
    replay_add(buf, torch.ones(E, 2), torch.full((E,), 7, dtype=torch.int32),
               torch.ones(E), torch.ones(E, 2), torch.zeros(E, dtype=torch.bool))
    batch = replay_sample(buf, torch.Generator().manual_seed(1), 16)
    assert (batch["action"] == 7).all() and (batch["obs"] == 1).all()


# ---------------------------------------------------------------- DQN
def test_dqn_td_target_and_loss_match_the_reference():
    env_j = JGridWorld(8, size=3, max_steps=15)
    cfg_j, cfg = _vector_cfg(env_j, jax_config), _vector_cfg(env_j)
    pj, pt = _bridged(env_j, 0)
    tj, tt = _bridged(env_j, 1)
    rng = np.random.default_rng(2)
    B, gamma = 12, 0.95
    batch = {
        "obs": rng.normal(size=(B,) + env_j.obs_shape).astype(np.float32),
        "action": rng.integers(0, env_j.num_actions, B).astype(np.int32),
        "reward": rng.normal(size=B).astype(np.float32),
        "next_obs": rng.normal(size=(B,) + env_j.obs_shape).astype(np.float32),
        "done": rng.random(B) < 0.25,
    }
    q_next = rng.normal(size=(B, 4)).astype(np.float32)
    np.testing.assert_allclose(
        dqn_td_target(torch.from_numpy(q_next),
                      torch.from_numpy(batch["reward"]),
                      torch.from_numpy(batch["done"]), gamma).numpy(),
        np.asarray(jdqn.dqn_td_target(jnp.asarray(q_next),
                                      jnp.asarray(batch["reward"]),
                                      jnp.asarray(batch["done"]), gamma)),
        rtol=1e-5, atol=1e-5)
    loss_j, m_j = jdqn.dqn_loss(pj, tj, _to_jax(batch), cfg_j, gamma)
    loss_t, m_t = dqn_loss(pt, tt, _to_torch(batch), cfg, gamma)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(m_t["q_mean"]), float(m_j["q_mean"]),
                               rtol=1e-5, atol=1e-5)


def test_dqn_epsilon_schedule_endpoints():
    """Linear ε schedule clamps at both ends and interpolates between."""
    hp = DQNConfig(eps_start=1.0, eps_end=0.05, eps_steps=100)
    agent = DQNAgent(_vector_cfg(GridWorld(8, size=3, device="cpu")), hp)
    j_agent = JDQNAgent(None, JDQNConfig(eps_start=1.0, eps_end=0.05,
                                         eps_steps=100))
    assert agent.epsilon(0) == pytest.approx(hp.eps_start)
    assert agent.epsilon(50) == pytest.approx(0.525)
    assert agent.epsilon(100) == pytest.approx(hp.eps_end)
    assert agent.epsilon(10_000) == pytest.approx(hp.eps_end)
    for step in (0, 1, 37, 99, 100, 5000):
        assert agent.epsilon(step) == pytest.approx(
            float(j_agent.epsilon(step)), rel=1e-6)


def test_dqn_target_sync_cadence():
    """The target tree hard-syncs exactly every ``target_sync`` updates and
    holds still in between."""
    target = {"w": torch.zeros(3)}
    updates = 0
    synced_at = []
    for step in range(1, 8):
        params = {"w": torch.full((3,), float(step))}
        target, updates = dqn_sync_target(target, params, updates,
                                          target_sync=3)
        assert updates == step
        if float(target["w"][0]) == float(step):
            synced_at.append(step)
        else:
            assert float(target["w"][0]) in (0.0, 3.0, 6.0)
    assert synced_at == [3, 6]


def _far_gridworld_state(rng, n, size, max_steps, T):
    """GridWorld states whose goal is out of reach in T moves; about half
    the rows time out on the T-th step."""
    lo, hi = rng.integers(0, 3, (n, 2)), rng.integers(size - 3, size, (n, 2))
    return {"pos": lo.astype(np.int32), "goal": hi.astype(np.int32),
            "t": np.where(rng.random(n) < 0.5, 0, max_steps - T).astype(
                np.int32)}


N_ENVS, T_STEPS, SIZE, MAX_STEPS, LR = 8, 4, 8, 20, 0.01


def _replay_env():
    env, env_j = (GridWorld(N_ENVS, size=SIZE, max_steps=MAX_STEPS,
                            device="cpu"),
                  JGridWorld(N_ENVS, size=SIZE, max_steps=MAX_STEPS))
    state = _far_gridworld_state(np.random.default_rng(30), N_ENVS, SIZE,
                                 MAX_STEPS, T_STEPS)
    return env, env_j, state


@pytest.fixture(scope="module")
def dqn_step():
    """One whole DQN train step on both sides (ε mid-schedule, a target
    network unlike the params), the reference's draws replayed into the
    port's: its explore uniforms and random actions for each env step and
    the replay indices after the last."""
    env, env_j, state = _replay_env()
    hp_j = JDQNConfig(t_max=T_STEPS, batch_size=16, eps_steps=10)
    hp = DQNConfig(t_max=T_STEPS, batch_size=16, eps_steps=10)
    agent_j, agent = (JDQNAgent(_vector_cfg(env_j, jax_config), hp_j),
                      DQNAgent(_vector_cfg(env), hp))
    pj, pt = _bridged(env_j, 3)
    tj, tt = _bridged(env_j, 4)
    step, cap = 5, 64
    key = jax.random.PRNGKey(5)
    opt_j, opt = jax_optimizer("rmsprop"), make_optimizer("rmsprop")
    obs_j = env_j.observe(_to_jax(state))
    ast_j = dict(agent_j.init_state(cap, env_j.obs_shape, pj, obs_j.dtype),
                 target=tj)
    train_j = jax.jit(agent_j.make_train_step(env_j, opt_j, jconstant(LR)))
    new_j, _, ast_j2, _, _, _, m_j = train_j(pj, opt_j.init(pj), ast_j,
                                             _to_jax(state), obs_j, key,
                                             jnp.asarray(step, jnp.int32))
    k, us, rands = key, [], []
    for _ in range(T_STEPS):
        k, k_eps, k_act, _ = jax.random.split(k, 4)
        rands.append(np.asarray(jax.random.randint(k_act, (N_ENVS,), 0, 4)))
        us.append(np.asarray(jax.random.uniform(k_eps, (N_ENVS,))))
    _, k_s = jax.random.split(k)
    idx = jax.random.randint(k_s, (16,), 0,
                             jnp.asarray(T_STEPS * N_ENVS, jnp.int32))
    draws = DQNDraws(torch.from_numpy(np.stack(us)),
                     torch.from_numpy(np.stack(rands)),
                     torch.from_numpy(np.array(idx)))
    ast = dict(agent.init_state(cap, env.obs_shape, pt, device="cpu"),
               target=tt)
    train = agent.make_train_step(env, opt, constant(LR))
    g = torch.Generator().manual_seed(0)
    new_t, _, ast2, _, _, m_t = train(pt, opt.init(pt), ast, _to_torch(state),
                                      env.observe(_to_torch(state)), g, g,
                                      step, draws=draws)
    return dict(new_j=new_j, m_j=m_j, ast_j=ast_j2, new_t=new_t, m_t=m_t,
                ast=ast2, explore=np.stack(us) < float(agent.epsilon(step)))


def test_one_dqn_train_step_matches_the_reference(dqn_step):
    s = dqn_step
    assert s["explore"].any() and not s["explore"].all()
    for k in ("loss", "q_mean", "reward_sum", "episodes"):
        np.testing.assert_allclose(float(s["m_t"][k]), float(s["m_j"][k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(s["m_t"]["episodes"]) > 0
    _assert_trees_close(s["new_t"], s["new_j"])
    ast, ast_j = s["ast"], s["ast_j"]
    assert ast["updates"] == int(ast_j["updates"]) == 1
    assert ast["replay"]["size"] == int(ast_j["replay"]["size"]) == 32
    # the replayed actions and rewards are the reference's, row for row
    for k in ("action", "reward", "done", "obs"):
        np.testing.assert_allclose(ast["replay"][k].numpy(),
                                   np.asarray(ast_j["replay"][k]), atol=0)


def test_dqn_target_is_not_moved_by_the_update(dqn_step):
    """The target (synced every 100 updates) is still the tree it was: no
    update wrote into it, though the params moved."""
    target = dqn_step["ast"]["target"]
    env, env_j, _ = _replay_env()
    _, tt = _bridged(env_j, 4)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(target),
                                                 tree_leaves(tt)))


# ---------------------------------------------------------------- lagged PAAC
def _injected_step(make_j, make_t, with_state, lr=LR):
    """One train step of a reference agent and its port from the same
    converted GridWorld state, the port replaying the reference rollout's
    actions. ``with_state``: lagged PAAC, whose stale copy differs from the
    params. Returns both sides' new params and metrics (and agent state)."""
    env, env_j, state = _replay_env()
    agent_j, agent = make_j(_vector_cfg(env_j, jax_config)), make_t(
        _vector_cfg(env))
    pj, pt = _bridged(env_j, 6)
    sj, st = _bridged(env_j, 7)
    key = jax.random.PRNGKey(8)
    opt_j, opt = jax_optimizer("rmsprop"), make_optimizer("rmsprop")
    obs_j = env_j.observe(_to_jax(state))
    acting = sj if with_state and agent_j.mode == "act" else pj
    _, _, _, traj_j = jax_rollout(agent_j.act_fn(), env_j, acting,
                                  _to_jax(state), obs_j, key, T_STEPS)
    actions = torch.from_numpy(np.array(traj_j.action))
    train_j = jax.jit(agent_j.make_train_step(env_j, opt_j, jconstant(lr)))
    train = agent.make_train_step(env, opt, constant(lr))
    g = torch.Generator().manual_seed(0)
    obs = env.observe(_to_torch(state))
    if with_state:
        out_j = train_j(pj, opt_j.init(pj), {"stale": sj, "since": jnp.int32(0)},
                        _to_jax(state), obs_j, key, jnp.int32(0))
        out_t = train(pt, opt.init(pt), {"stale": st, "since": 0},
                      _to_torch(state), obs, g, g, 0, actions=actions)
        return out_j[0], out_j[-1], out_t[0], out_t[-1], out_t[2]
    out_j = train_j(pj, opt_j.init(pj), _to_jax(state), obs_j, key,
                    jnp.int32(0))
    out_t = train(pt, opt.init(pt), _to_torch(state), obs, g, g, 0,
                  actions=actions)
    return out_j[0], out_j[-1], out_t[0], out_t[-1], None


@pytest.mark.parametrize("mode", ["grad", "act"])
def test_one_lagged_update_matches_the_reference(mode):
    new_j, m_j, new_t, m_t, ast = _injected_step(
        lambda c: JLaggedPAACAgent(c, JLaggedConfig(t_max=T_STEPS, delay=4),
                                   mode),
        lambda c: LaggedPAACAgent(c, LaggedConfig(t_max=T_STEPS, delay=4),
                                  mode), True)
    for k in ("loss", "policy_loss", "value_loss", "entropy", "reward_sum",
              "episodes"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert float(m_t["episodes"]) > 0
    _assert_trees_close(new_t, new_j)
    assert ast["since"] == 1  # delay 4: the stale copy is kept


def test_one_ppo_train_step_matches_the_reference():
    """Four epochs over one rollout; the advantages are normalised with the
    population std, so ``correction=1`` would fail this within 1e-5."""
    new_j, m_j, new_t, m_t, _ = _injected_step(
        lambda c: JPPOAgent(c, JPPOConfig(t_max=T_STEPS, epochs=4)),
        lambda c: PPOAgent(c, PPOConfig(t_max=T_STEPS, epochs=4)), False,
        lr=0.05)
    for k in ("loss", "policy_loss", "value_loss", "entropy", "clip_frac",
              "reward_sum", "episodes"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert float(m_t["clip_frac"]) > 0  # the later epochs clip
    _assert_trees_close(new_t, new_j)


# ---------------------------------------------------------------- evaluate
def test_evaluate_gives_the_reference_returns_from_its_starts():
    """Greedy, 3 seeds x 10 runs over 8 envs (two batches a seed, the
    second taking 2): the reference's reset states injected, the same
    params give the same per-seed returns exactly. Every episode ends by
    step 12, so the port stops each batch at its first check (step 32)
    while the reference runs all 100 steps."""
    n, n_runs, seeds = 8, 10, 3
    env, env_j = (GridWorld(n, size=4, max_steps=12, device="cpu"),
                  JGridWorld(n, size=4, max_steps=12))
    pj, pt = _bridged(env_j, 9)
    cfg_j, cfg = _vector_cfg(env_j, jax_config), _vector_cfg(env)
    key = jax.random.PRNGKey(42)
    want = jax_evaluate(JPAACAgent(cfg_j).act_fn(), env_j, pj, key,
                        n_runs=n_runs, n_actor_seeds=seeds, max_steps=100)
    starts, k = [], key
    for seed in range(seeds):  # the reference's key walk
        k, k_reset = jax.random.split(jax.random.fold_in(k, seed))
        for _ in range(math.ceil(n_runs / n)):
            k_reset, k_run = jax.random.split(k_reset)
            starts.append(_to_torch(env_j.reset(k_run)))
    got = evaluate(PAACAgent(cfg).act_fn(), env, pt,
                   torch.Generator().manual_seed(0), n_runs=n_runs,
                   n_actor_seeds=seeds, max_steps=100, start_states=starts)
    assert got["per_seed"] == want["per_seed"]
    assert got["best_of_k"] == want["best_of_k"]
    assert got["mean"] == pytest.approx(want["mean"], rel=1e-12)
    assert len(set(got["per_seed"])) > 1


def test_evaluate_protocol_and_training_gain():
    """``tests/test_evaluation.py``'s protocol at lr 0.03, not 0.01: at 0.01
    the port's policy is still near uniform after 250 iterations, and its
    greedy best-of-3 gains 0.001 (one episode one step shorter); at 0.03
    it gains 0.24–0.59 over seeds 0–2."""
    env = GridWorld(10, size=4, max_steps=20, device="cpu")
    agent = PAACAgent(_vector_cfg(env), PAACConfig(t_max=5))
    rl = ParallelRL(env, agent, lr_schedule=constant(0.03), seed=0,
                    device="cpu")
    act = agent.act_fn()

    def run():
        return evaluate(act, env, rl.params, torch.Generator().manual_seed(42),
                        n_runs=10, n_actor_seeds=3, max_steps=25)

    before = run()
    assert len(before["per_seed"]) == 3
    assert before["best_of_k"] >= before["mean"]
    assert run() == before  # one generator seed, one evaluation
    rl.run(250)
    after = run()
    assert after["best_of_k"] > before["best_of_k"]


# ---------------------------------------------------------------- ParallelRL
AGENTS = {
    "dqn": (lambda c: DQNAgent(c, DQNConfig(t_max=3, batch_size=16,
                                            eps_steps=20, target_sync=4)),
            "adam"),
    "lagged_grad": (lambda c: LaggedPAACAgent(c, LaggedConfig(t_max=3,
                                                              delay=3),
                                              "grad"), "rmsprop"),
    "lagged_act": (lambda c: LaggedPAACAgent(c, LaggedConfig(t_max=3,
                                                             delay=3),
                                             "act"), "rmsprop"),
    "ppo": (lambda c: PPOAgent(c, PPOConfig(t_max=4, epochs=2)), "adam"),
}


@pytest.mark.parametrize("name", list(AGENTS))
def test_parallel_rl_drives_each_agent_and_one_seed_is_one_run(name):
    env = GridWorld(8, size=3, max_steps=10, device="cpu")
    make, opt = AGENTS[name]

    def run(seed):
        rl = ParallelRL(env, make(_vector_cfg(env)), optimizer=opt,
                        lr_schedule=constant(0.005), seed=seed,
                        replay_capacity=100, device="cpu")
        before = [t.clone() for t in tree_leaves(rl.params)]
        res = rl.run(12)
        assert all(math.isfinite(v) for v in res.mean_metrics.values())
        assert not all(torch.equal(a, b) for a, b in
                       zip(before, tree_leaves(rl.params)))
        return rl, res

    (a, ra), (b, rb), (c, _) = run(11), run(11), run(12)
    assert ra.mean_metrics == rb.mean_metrics
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                 tree_leaves(b.params)))
    assert not all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                     tree_leaves(c.params)))
    if name == "dqn":
        replay = a.agent_state["replay"]
        assert (replay["size"], replay["ptr"]) == (100, 12 * 3 * 8 % 100)
        assert a.agent_state["updates"] == 12
    elif name.startswith("lagged"):
        assert a.agent_state["since"] == 12 % 3
    else:
        assert a.agent_state is None


def test_lag_one_matches_paac_bitwise():
    """delay=1 refreshes the stale copy every update -> PAAC, bit for bit."""
    env = GridWorld(8, size=3, max_steps=15, device="cpu")
    cfg = _vector_cfg(env)
    paac = ParallelRL(env, PAACAgent(cfg, PAACConfig(t_max=4)),
                      lr_schedule=constant(0.005), seed=7, device="cpu")
    lagged = ParallelRL(env, LaggedPAACAgent(cfg, LaggedConfig(t_max=4,
                                                               delay=1),
                                             mode="grad"),
                        lr_schedule=constant(0.005), seed=7, device="cpu")
    rp, rg = paac.run(10), lagged.run(10)
    assert rp.mean_metrics == rg.mean_metrics
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(paac.params),
                                                 tree_leaves(lagged.params)))


@pytest.mark.parametrize("mode", ["grad", "act"])
def test_the_stale_copy_lags_the_params(mode):
    env = GridWorld(8, size=3, max_steps=15, device="cpu")
    rl = ParallelRL(env, LaggedPAACAgent(_vector_cfg(env),
                                         LaggedConfig(t_max=4, delay=3), mode),
                    lr_schedule=constant(0.005), seed=7, device="cpu")
    first = [t.clone() for t in tree_leaves(rl.params)]
    rl.run(1)
    stale = tree_leaves(rl.agent_state["stale"])
    assert all(torch.equal(a, b) for a, b in zip(stale, first))
    assert not all(torch.equal(a, b) for a, b in
                   zip(stale, tree_leaves(rl.params)))
    rl.run(2)  # the third update refreshes the copy
    assert rl.agent_state["since"] == 0
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(rl.agent_state["stale"]),
                   tree_leaves(rl.params)))


def test_dqn_learns_gridworld():
    """The reference's budget of 400 iterations: of 100 to 400 it is the
    smallest that gained on each of seeds 3–8 (by 10.1–21.3; 300 lost on
    seed 6)."""
    env = GridWorld(16, size=3, max_steps=20, device="cpu")
    agent = DQNAgent(_vector_cfg(env), DQNConfig(t_max=4, batch_size=64,
                                                 eps_steps=150,
                                                 target_sync=25))
    rl = ParallelRL(env, agent, optimizer="adam", lr_schedule=constant(1e-3),
                    seed=3, replay_capacity=5_000, device="cpu")
    first = rl.run(30).mean_metrics["reward_sum"]
    rl.run(400)
    last = rl.run(30).mean_metrics["reward_sum"]
    assert last > first + 0.3, (first, last)


def test_ppo_learns_gridworld():
    env = GridWorld(32, size=4, max_steps=30, device="cpu")
    agent = PPOAgent(_vector_cfg(env), PPOConfig(t_max=16, epochs=2))
    rl = ParallelRL(env, agent, optimizer="adam", lr_schedule=constant(3e-3),
                    seed=0, device="cpu")
    before = rl.run(10).mean_metrics["reward_sum"]
    rl.run(60)
    after = rl.run(10).mean_metrics["reward_sum"]
    assert after > before, (before, after)

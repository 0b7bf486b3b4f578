"""The port's training path against the JAX package's (CPU, small shapes).

The same numpy inputs go through ``repro`` and ``repro_torch``:

* every optimizer's update on identical grads and state (one case with a
  global norm above the clip of 40), and the schedules — tolerance 1e-6;
* logits and values of ``paac_nips``, ``paac_nature`` (full size, batch 4)
  and ``paac_vector`` on parameters bridged from JAX — rtol 1e-4, atol 1e-5;
* GridWorld, Catch, AtariLike and FrameStack on deterministic transitions
  from converted states (no reset, no spawn) — exact; resets and spawns
  are random in both frameworks and are held only in distribution;
* the behaviour log-prob and value at acting time — 1e-6;
* one PAAC update on a replayed trajectory against JAX's ``value_and_grad``
  over ``trajectory_forward`` and ``paac_losses``, then the reference's
  RMSProp: loss, grads and new parameters — atol 1e-5, rtol 1e-4.

Torch against torch: same-seed runs are bitwise equal, and PAAC learns
GridWorld and Catch (mirrors of ``tests/test_system.py`` and
``tests/test_agents.py``). Entry points raise without a card unless the
CPU is asked for. A token policy acts and learns on the last position of
its context, as the reference's does.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.agents.paac import PAACAgent as JPAACAgent  # noqa: E402
from repro.core.agents.paac import PAACConfig as JPAACConfig  # noqa: E402
from repro.core.agents.paac import paac_losses as jax_losses  # noqa: E402
from repro.core.agents.paac import trajectory_forward as jax_forward  # noqa: E402
from repro.core.agents.paac import (  # noqa: E402
    trajectory_logits_values as jax_traj_lv)
from repro.core.rollout import Transition as JTransition  # noqa: E402
from repro.envs import AtariLike as JAtariLike  # noqa: E402
from repro.envs import Catch as JCatch  # noqa: E402
from repro.envs import FrameStack as JFrameStack  # noqa: E402
from repro.envs import GridWorld as JGridWorld  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.models import policy_apply as jax_apply  # noqa: E402
from repro.optim import make_optimizer as jax_optimizer  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ParallelRL  # noqa: E402
from repro_torch.core.agents import PAACAgent, PAACConfig  # noqa: E402
from repro_torch.core.agents.paac import (  # noqa: E402
    loss_and_grads, trajectory_logits_values)
from repro_torch.core.framework import MetricsAccumulator  # noqa: E402
from repro_torch.core.rollout import Transition, rollout  # noqa: E402
from repro_torch.envs import (AtariLike, Catch, FrameStack,  # noqa: E402
                              GridWorld, narrow_vector_env)
from repro_torch.launch import paper_atari  # noqa: E402
from repro_torch.models import init_policy, policy_apply  # noqa: E402
from repro_torch.optim import (clip_by_global_norm, constant,  # noqa: E402
                               linear_anneal, make_optimizer, paac_scaled_lr)
from repro_torch.utils.bridge import (params_from_numpy,  # noqa: E402
                                      params_to_numpy)
from repro_torch.utils.tree import tree_leaves  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(got_np, want, *, rtol, atol):
    want_leaves, want_def = jax.tree_util.tree_flatten(_np_tree(want))
    got_leaves, got_def = jax.tree_util.tree_flatten(got_np)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  _np_tree(tree))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------- optimizers
OPTIMIZERS = [("rmsprop", {}), ("rmsprop", {"clip_norm": None}),
              ("adam", {}), ("sgd", {}), ("sgd", {"momentum": 0.9})]


def _opt_tree(rng, scale=1.0):
    tree = {"trunk": {"convs": [{"w": rng.standard_normal((3, 3, 2, 4)),
                                 "b": rng.standard_normal(4)}],
                      "dense": {"w": rng.standard_normal((6, 5))}},
            "heads": {"value": {"b": rng.standard_normal(1)}}}
    return jax.tree_util.tree_map(lambda a: (a * scale).astype(np.float32),
                                  tree)


@pytest.mark.parametrize("big", [False, True], ids=["norm<40", "norm>40"])
@pytest.mark.parametrize("kind,kw", OPTIMIZERS,
                         ids=lambda x: x if isinstance(x, str) else str(x))
def test_optimizer_updates_match_the_reference(kind, kw, big):
    """Two updates in a row, so the state carries; lr 0.01."""
    rng = np.random.default_rng(7)
    params = _opt_tree(rng)
    grads = [_opt_tree(rng, 30.0 if big else 0.1) for _ in range(2)]
    jopt, topt = jax_optimizer(kind, **kw), make_optimizer(kind, **kw)
    pj, pt = _to_jax(params), _to_torch(params)
    sj, st = jopt.init(pj), topt.init(pt)
    for g in grads:
        norm = math.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                             for x in jax.tree_util.tree_leaves(g)))
        assert (norm > 40) == big
        pj, sj = jopt.update(_to_jax(g), sj, pj, jnp.float32(0.01))
        pt, st = topt.update(_to_torch(g), st, pt, 0.01)
        _assert_trees_close(jax.tree_util.tree_map(lambda t: t.numpy(), pt),
                            pj, rtol=1e-6, atol=1e-6)
        _assert_trees_close(jax.tree_util.tree_map(lambda t: t.numpy(), st),
                            sj, rtol=1e-6, atol=1e-6)


def test_update_leaves_its_arguments_as_they_were():
    rng = np.random.default_rng(1)
    pt, g = _to_torch(_opt_tree(rng)), _to_torch(_opt_tree(rng, 1.0))
    before = [t.clone() for t in tree_leaves(pt)]
    opt = make_optimizer("rmsprop")
    state = opt.init(pt)
    opt.update(g, state, pt, 0.5)
    for a, b in zip(before, tree_leaves(pt)):
        assert torch.equal(a, b)
    assert all(float(s.abs().sum()) == 0 for s in tree_leaves(state))


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_clip_by_global_norm_matches_the_reference(scale):
    from repro.optim import clip_by_global_norm as jax_clip

    g = _opt_tree(np.random.default_rng(3), scale)
    cj, nj = jax_clip(_to_jax(g), 40.0)
    ct, nt = clip_by_global_norm(_to_torch(g), 40.0)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-6)
    _assert_trees_close(jax.tree_util.tree_map(lambda t: t.numpy(), ct), cj,
                        rtol=1e-6, atol=1e-6)


def test_schedules_match_the_reference():
    for step in (0, 1, 50, 99, 100, 250):
        for t_fn, j_fn in ((constant(0.3), jsched.constant(0.3)),
                           (linear_anneal(1e-3, 100, 1e-4),
                            jsched.linear_anneal(1e-3, 100, 1e-4)),
                           (paac_scaled_lr(32), jsched.paac_scaled_lr(32))):
            np.testing.assert_allclose(t_fn(step), float(j_fn(step)),
                                       rtol=1e-6)


# ---------------------------------------------------------------- models
def _bridged(arch, seed=0):
    cfg_j, cfg = jax_config(arch), get_config(arch)
    pj = jax_init(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg, pj, params_from_numpy(_np_tree(pj), "cpu")


@pytest.mark.parametrize("arch", ["paac_nips", "paac_nature", "paac_vector"])
def test_logits_and_values_match_the_reference_on_bridged_params(arch):
    cfg_j, cfg, pj, pt = _bridged(arch)
    obs = np.random.default_rng(5).random((4,) + cfg.obs_shape,
                                          dtype=np.float32)
    lj, vj, _ = jax_apply(pj, cfg_j, jnp.asarray(obs))
    lt, vt, aux = policy_apply(pt, cfg, torch.from_numpy(obs))
    assert aux == {}
    assert lt.shape == (4, cfg.num_actions) and vt.shape == (4,)
    assert lt.dtype == vt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["paac_nips", "paac_nature", "paac_vector"])
def test_port_init_has_the_reference_tree_and_bridge_round_trips(arch):
    cfg_j, cfg, pj, pt = _bridged(arch)
    own = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    back = params_to_numpy(own)
    want = _np_tree(pj)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(pt)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    if cfg.cnn_spec:  # conv weights cross as HWIO -> OIHW
        feat, kern, _ = cfg.cnn_spec[0]
        assert tuple(pt["trunk"]["convs"][0]["w"].shape) == (
            feat, cfg.obs_shape[-1], kern, kern)


def test_token_families_have_no_training_pass_yet():
    """Once a refusal (ROADMAP Queue 1 item 11), now the token policies'
    acting and learning forwards: ``act_fn`` and
    ``trajectory_logits_values`` of reduced qwen2-7b take the last position
    of each token context, as the reference's do (1e-4)."""
    cfg_j = jax_config("qwen2-7b").reduced().replace(num_actions=16)
    cfg = get_config("qwen2-7b").reduced().replace(num_actions=16)
    pj = jax_init(jax.random.PRNGKey(3), cfg_j)
    pt = params_from_numpy(_np_tree(pj), "cpu")
    rng = np.random.default_rng(4)
    obs = rng.integers(0, 16, (3, 2, 8)).astype(np.int32)  # (T, E, ctx)
    lj, vj = JPAACAgent(cfg_j).act_fn()(pj, jnp.asarray(obs[0]))
    lt, vt = PAACAgent(cfg).act_fn()(pt, torch.from_numpy(obs[0]))
    assert lt.shape == (2, 16) and vt.shape == (2,)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-4, atol=1e-4)
    zeros = np.zeros((3, 2), np.float32)
    tr = dict(obs=obs, action=np.zeros((3, 2), np.int32), reward=zeros,
              done=zeros.astype(bool), value=zeros, logp=zeros)
    lj, vj = jax_traj_lv(pj, cfg_j, JTransition(
        **{k: jnp.asarray(v) for k, v in tr.items()}))
    lt, vt = trajectory_logits_values(pt, cfg, Transition(
        **{k: torch.from_numpy(v) for k, v in tr.items()}))
    assert lt.shape == (6, 16) and vt.shape == (6,)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------- envs
def _keys(n, seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _state_np(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _assert_states_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


def _gridworld_state(rng, n, size):
    return {"pos": rng.integers(0, size, (n, 2)).astype(np.int32),
            "goal": rng.integers(0, size, (n, 2)).astype(np.int32),
            "t": rng.integers(0, 12, n).astype(np.int32)}


def _catch_state(rng, n, rows, cols):
    return {"ball": np.stack([rng.integers(0, rows - 1, n),
                              rng.integers(0, cols, n)], 1).astype(np.int32),
            "paddle": rng.integers(0, cols, n).astype(np.int32)}


def _atari_state(rng, n, rows=(0, 72), lives=(1, 6)):
    return {"ball": np.stack([rng.integers(*rows, n),
                              rng.integers(3, 82, n),
                              np.full(n, 2),
                              rng.integers(-2, 3, n)], 1).astype(np.int32),
            "paddle": rng.integers(8, 77, n).astype(np.int32),
            "lives": rng.integers(*lives, n).astype(np.int32)}


ENV_CASES = {
    "gridworld": (lambda n, dev: GridWorld(n, size=4, max_steps=12, device=dev),
                  lambda n: JGridWorld(n, size=4, max_steps=12),
                  lambda rng, n: _gridworld_state(rng, n, 4)),
    "catch": (lambda n, dev: Catch(n, rows=6, cols=5, device=dev),
              lambda n: JCatch(n, rows=6, cols=5),
              lambda rng, n: _catch_state(rng, n, 6, 5)),
    "atari_like": (lambda n, dev: AtariLike(n, device=dev),
                   lambda n: JAtariLike(n),
                   lambda rng, n: _atari_state(rng, n)),
}


@pytest.mark.parametrize("name", list(ENV_CASES))
def test_env_transitions_match_the_reference_exactly(name):
    """Converted states, the same actions: the raw transition (no reset;
    for AtariLike no ball reaches the bottom, so no spawn) and the
    observation agree exactly; through the auto-resetting ``step``, rows
    that did not finish agree exactly too, and every row's reward and done
    are the pre-reset ones."""
    make, make_j, make_state = ENV_CASES[name]
    n = 64
    rng = np.random.default_rng(11)
    env, env_j = make(n, "cpu"), make_j(n)
    state = make_state(rng, n)
    actions = rng.integers(0, env.num_actions, n)
    sj, rj, dj = jax.vmap(env_j._step_one)(_to_jax(state),
                                          jnp.asarray(actions, jnp.int32),
                                          _keys(n))
    st, rt, dt = env._step_batch(_to_torch(state), torch.from_numpy(actions),
                                 torch.Generator().manual_seed(0))
    _assert_states_equal(st, _state_np(sj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj, np.float32))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(env.observe(_to_torch(state)).numpy(),
                                  np.asarray(env_j.observe(_to_jax(state))))

    s2, obs, r2, d2 = env.step(_to_torch(state), torch.from_numpy(actions),
                               torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(r2.numpy(), np.asarray(rj, np.float32))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(dj))
    keep = ~np.asarray(dj)
    if name != "atari_like":  # both outcomes occur in the sample
        assert keep.any() and (~keep).any()
    want_obs = np.asarray(env_j.observe(sj))
    np.testing.assert_array_equal(obs.numpy()[keep], want_obs[keep])
    for k, v in _state_np(sj).items():
        np.testing.assert_array_equal(s2[k].numpy()[keep], v[keep])


def test_atari_like_rewards_lives_and_spawns_at_the_bottom():
    """Balls that reach the bottom within the 4-frame repeat: ±1 rewards,
    lives and done agree exactly with the reference; the respawned ball is
    drawn differently by the two frameworks, so it is held to the spawn's
    distribution (row 0 falling 2 a frame, columns 3..80, drift -2..2)."""
    n = 256
    rng = np.random.default_rng(12)
    env, env_j = AtariLike(n, device="cpu"), JAtariLike(n)
    state = _atari_state(rng, n, rows=(72, 80), lives=(1, 3))
    actions = rng.integers(0, 3, n)
    sj, rj, dj = jax.vmap(env_j._step_one)(_to_jax(state),
                                          jnp.asarray(actions, jnp.int32),
                                          _keys(n))
    st, rt, dt = env._step_batch(_to_torch(state), torch.from_numpy(actions),
                                 torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert set(np.unique(rt.numpy())) == {-1.0, 1.0}
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert dt.any() and not dt.all()
    for k in ("paddle", "lives"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]))
    ball = st["ball"].numpy()
    assert set(np.unique(ball[:, 0])) <= {0, 2, 4, 6}
    assert (ball[:, 2] == 2).all()
    assert ((ball[:, 1] >= 3) & (ball[:, 1] <= 81)).all()
    assert ((ball[:, 3] >= -2) & (ball[:, 3] <= 2)).all()


def test_atari_like_noop_start_is_the_reference_noop_loop():
    """The tabulated no-op start equals the reference's ``fori_loop`` of
    raw frames with action 1, from every spawn column and drift, for every
    count 1..30."""
    env_j = JAtariLike(1)
    cols, vxs, ns = np.meshgrid(np.arange(3, 81), np.arange(-2, 3),
                                np.arange(1, 31), indexing="ij")
    cols, vxs, ns = cols.ravel(), vxs.ravel(), ns.ravel()
    m = cols.size
    rng = np.random.default_rng(13)
    state = {"ball": np.stack([np.zeros(m), cols, np.full(m, 2), vxs],
                              1).astype(np.int32),
             "paddle": rng.integers(8, 76, m).astype(np.int32),
             "lives": np.full(m, 5, np.int32)}
    key = jax.random.PRNGKey(0)

    def noops(s, n):
        return jax.lax.fori_loop(
            0, n, lambda _, s: env_j._physics(s, jnp.asarray(1, jnp.int32),
                                               key)[0], s)

    want = jax.vmap(noops)(_to_jax(state), jnp.asarray(ns, jnp.int32))
    env = AtariLike(m, device="cpu")
    got = env.noop_start(_to_torch(state), torch.from_numpy(ns.astype(np.int32)))
    _assert_states_equal(got, _state_np(want))


def test_atari_like_refuses_a_noop_start_that_reaches_the_bottom():
    AtariLike(2, max_noops=39, device="cpu")
    with pytest.raises(ValueError, match="no-op"):
        AtariLike(2, max_noops=40, device="cpu")


def test_resets_agree_in_distribution():
    """Reset draws differ between threefry and torch; their distributions
    agree: same supports, and means within 5 standard errors."""
    n = 4096
    cases = [(GridWorld(n, size=5, device="cpu"), JGridWorld(n, size=5)),
             (Catch(n, device="cpu"), JCatch(n)),
             (AtariLike(n, device="cpu"), JAtariLike(n))]
    for env, env_j in cases:
        st = env.reset(torch.Generator().manual_seed(3))
        sj = _state_np(env_j.reset(jax.random.PRNGKey(3)))
        for k, v in sj.items():
            got = st[k].numpy()
            assert got.dtype == v.dtype and got.shape == v.shape, k
            assert set(np.unique(got)) == set(np.unique(v)), k
            se = np.sqrt(v.var(axis=0) / n + got.var(axis=0) / n) + 1e-12
            assert (np.abs(got.mean(axis=0) - v.mean(axis=0)) <= 5 * se).all(), k


def test_frame_stack_matches_the_reference():
    """FrameStack over AtariLike from converted states: rows whose ball
    did not reach the bottom (no spawn, no end) agree exactly on the stack
    and observation; every row on reward and done; finished rows get a
    stack of four copies of their fresh frame, as in the reference."""
    n = 48
    rng = np.random.default_rng(14)
    inner = _atari_state(rng, n, rows=(40, 80), lives=(1, 3))
    stack = (rng.random((n, 84, 84, 4)) < 0.05).astype(np.float32)
    env, env_j = FrameStack(AtariLike(n, device="cpu"), 4), JFrameStack(
        JAtariLike(n), 4)
    assert env.obs_shape == tuple(env_j.obs_shape) == (84, 84, 4)
    actions = rng.integers(0, 3, n)
    sj, oj, rj, dj = env_j.step({"inner": _to_jax(inner),
                                 "stack": jnp.asarray(stack)},
                                jnp.asarray(actions, jnp.int32),
                                jax.random.PRNGKey(1))
    st, ot, rt, dt = env.step({"inner": _to_torch(inner),
                               "stack": torch.from_numpy(stack)},
                              torch.from_numpy(actions),
                              torch.Generator().manual_seed(1))
    done = np.asarray(dj)
    assert done.any() and not done.all()
    np.testing.assert_array_equal(dt.numpy(), done)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    calm = np.asarray(rj) == 0  # no ball reached the bottom: no spawn
    assert calm.any() and (~calm & ~done).any()
    np.testing.assert_array_equal(ot.numpy()[calm], np.asarray(oj)[calm])
    assert torch.equal(ot, st["stack"])
    fresh = ot.numpy()[done]
    assert (fresh == fresh[..., :1]).all()
    # reset: the first frame repeated four times
    s0 = env.reset(torch.Generator().manual_seed(2))
    frame = env.env.observe(s0["inner"])
    assert torch.equal(env.observe(s0), frame[..., None].expand(-1, -1, -1, 4))


def test_narrowed_env_keeps_its_dynamics_at_the_new_width():
    env = FrameStack(AtariLike(8, device="cpu"), 4)
    half = narrow_vector_env(env, 4)
    assert (env.n_envs, env.env.n_envs) == (8, 8)
    assert (half.n_envs, half.env.n_envs) == (4, 4)
    s = half.reset(torch.Generator().manual_seed(0))
    s, obs, r, d = half.step(s, torch.ones(4, dtype=torch.int64),
                             torch.Generator().manual_seed(1))
    assert obs.shape == (4, 84, 84, 4) and r.shape == d.shape == (4,)


# ---------------------------------------------------------------- acting
def test_behaviour_logp_and_values_match_the_reference():
    """A port rollout on GridWorld with bridged ``paac_vector`` params: at
    every step, the logged value and log π(a|s) equal the reference's
    ``policy_apply`` and its gathered-logit-minus-logsumexp on the same
    observation and action."""
    n, T = 16, 4
    env = GridWorld(n, size=4, max_steps=30, device="cpu")
    cfg_j = jax_config("paac_vector").replace(obs_shape=env.obs_shape,
                                              num_actions=env.num_actions)
    cfg = get_config("paac_vector").replace(obs_shape=env.obs_shape,
                                            num_actions=env.num_actions)
    pj = jax_init(jax.random.PRNGKey(4), cfg_j)
    pt = params_from_numpy(_np_tree(pj), "cpu")
    agent = PAACAgent(cfg, PAACConfig(t_max=T))
    g = torch.Generator().manual_seed(0)
    state = env.reset(g)
    _, _, traj = rollout(agent.act_fn(), env, pt, state, env.observe(state),
                         torch.Generator().manual_seed(1), g, T)
    assert isinstance(traj, Transition)
    assert traj.obs.shape == (T, n) + env.obs_shape
    assert traj.action.dtype == torch.int64
    assert not traj.logp.requires_grad and not traj.value.requires_grad
    for t in range(T):
        logits, value, _ = jax_apply(pj, cfg_j, jnp.asarray(traj.obs[t].numpy()))
        a = jnp.asarray(traj.action[t].numpy())
        want = (jnp.take_along_axis(logits, a[:, None], axis=1)[:, 0]
                - jax.scipy.special.logsumexp(logits, axis=1))
        np.testing.assert_allclose(traj.logp[t].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(traj.value[t].numpy(), np.asarray(value),
                                   rtol=1e-6, atol=1e-6)


def test_rollout_replays_given_actions():
    env = Catch(6, rows=6, cols=5, device="cpu")
    agent = PAACAgent(get_config("paac_vector").replace(
        obs_shape=env.obs_shape, num_actions=env.num_actions), PAACConfig())
    params = init_policy(agent.cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    actions = torch.from_numpy(np.random.default_rng(0).integers(0, 3, (3, 6)))
    g = torch.Generator().manual_seed(0)
    state = env.reset(g)
    _, _, traj = rollout(agent.act_fn(), env, params, state,
                         env.observe(state), torch.Generator(), g, 3,
                         actions=actions)
    assert torch.equal(traj.action, actions)


# ---------------------------------------------------------------- update
def _replayed_trajectory(cfg, T, E, seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.random((T, E) + tuple(cfg.obs_shape), dtype=np.float32),
        action=rng.integers(0, cfg.num_actions, (T, E)),
        reward=rng.standard_normal((T, E)).astype(np.float32),
        done=rng.random((T, E)) < 0.2,
        value=rng.standard_normal((T, E)).astype(np.float32),
        logp=-rng.random((T, E)).astype(np.float32),
    ), rng.standard_normal(E).astype(np.float32)


@pytest.mark.parametrize("arch", ["paac_vector", "paac_nature"])
def test_one_paac_update_matches_the_reference(arch):
    """Loss, every gradient leaf and every new parameter of one PAAC update
    on the same replayed trajectory (T=3, E=4) and bootstrap: JAX's
    ``value_and_grad`` over ``trajectory_forward`` + ``paac_losses`` and
    its RMSProp, against the port's ``loss_and_grads`` and update step."""
    cfg_j, cfg, pj, pt = _bridged(arch, seed=6)
    hp_j, hp = JPAACConfig(t_max=3), PAACConfig(t_max=3)
    tr, boot = _replayed_trajectory(cfg, 3, 4, seed=8)
    lr = 0.0224
    traj_j = JTransition(**{k: jnp.asarray(v, jnp.int32 if k == "action"
                                           else None) for k, v in tr.items()})

    def loss_fn(p):
        lg, vl, ac, rt = jax_forward(p, cfg_j, hp_j, traj_j, jnp.asarray(boot))
        return jax_losses(lg, vl, ac, rt, hp_j.entropy_beta, hp_j.value_coef)

    (loss_j, metrics_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(pj)
    opt_j = jax_optimizer("rmsprop")
    new_j, state_j = opt_j.update(grads_j, opt_j.init(pj), pj, jnp.float32(lr))

    traj_t = Transition(**{k: torch.from_numpy(v) for k, v in tr.items()})
    loss_t, metrics_t, grads_t = loss_and_grads(pt, cfg, hp, traj_t,
                                                torch.from_numpy(boot))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4, atol=1e-5)
    for k in ("policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]),
                                   rtol=1e-4, atol=1e-5)
    _assert_trees_close(params_to_numpy(grads_t), grads_j, rtol=1e-4, atol=1e-5)

    opt = make_optimizer("rmsprop")
    update = PAACAgent(cfg, hp).make_update_step(opt, constant(lr))
    new_t, state_t, metrics = update(pt, opt.init(pt), traj_t,
                                     torch.from_numpy(boot), 0)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_j),
                               rtol=1e-4, atol=1e-5)
    _assert_trees_close(params_to_numpy(new_t), new_j, rtol=1e-4, atol=1e-5)
    _assert_trees_close(params_to_numpy(state_t["sq"]), state_j["sq"],
                        rtol=1e-4, atol=1e-5)
    assert not any(t.requires_grad for t in tree_leaves(new_t))


# ---------------------------------------------------------------- end to end
def _vector_cfg(env):
    return get_config("paac_vector").replace(obs_shape=env.obs_shape,
                                             num_actions=env.num_actions)


def test_deterministic_same_seed():
    env = GridWorld(8, size=3, max_steps=10, device="cpu")
    cfg = _vector_cfg(env)

    def run(seed):
        agent = PAACAgent(cfg, PAACConfig(t_max=3))
        rl = ParallelRL(env, agent, lr_schedule=constant(0.01), seed=seed,
                        device="cpu")
        rl.run(15)
        return tree_leaves(rl.params)

    p1, p2, p3 = run(123), run(123), run(124)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert not all(torch.equal(a, b) for a, b in zip(p1, p3))


def test_paac_learns_gridworld():
    env = GridWorld(32, size=4, max_steps=30, device="cpu")
    agent = PAACAgent(_vector_cfg(env), PAACConfig(t_max=5))
    rl = ParallelRL(env, agent, lr_schedule=constant(0.01), seed=1,
                    device="cpu")
    first = rl.run(30).mean_metrics["reward_sum"]
    rl.run(250)
    last = rl.run(30).mean_metrics["reward_sum"]
    assert last > first + 0.5, (first, last)


def test_paac_learns_catch():
    env = Catch(32, rows=6, cols=5, device="cpu")
    agent = PAACAgent(_vector_cfg(env), PAACConfig(t_max=5))
    rl = ParallelRL(env, agent, lr_schedule=constant(0.01), seed=2,
                    device="cpu")
    first = rl.run(30).mean_metrics["reward_sum"]
    rl.run(400)
    last = rl.run(30).mean_metrics["reward_sum"]
    assert last > first + 1.0, (first, last)


def test_lazy_and_eager_metrics_agree():
    metrics = [{"loss": torch.tensor(0.5 * i), "episodes": torch.tensor(i)}
               for i in range(5)]
    eager, lazy = MetricsAccumulator(), MetricsAccumulator(lazy=True)
    for m in metrics:
        eager.update(m)
        lazy.update(m)
    lazy.drain_ready()  # CPU scalars are ready at once
    assert lazy.cumulative_nowait("loss") == eager.cumulative("loss") == 5.0
    a, b = eager.result(40, 8), lazy.result(40, 8)
    assert a.mean_metrics == b.mean_metrics and a.episodes == b.episodes == 10


def test_entry_points_raise_without_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GridWorld(4)
    env = GridWorld(4, device="cpu")
    agent = PAACAgent(_vector_cfg(env), PAACConfig(t_max=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParallelRL(env, agent)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_atari.main(["--iters", "1", "--n-envs", "2"])
    rl = ParallelRL(env, agent, device="cpu")
    assert rl.agent_state is None and isinstance(rl.params, dict)


def test_parallel_rl_refuses_what_it_does_not_drive():
    """ParallelRL is algorithm agnostic: it drives DQN, lagged PAAC and PPO
    (and any agent with a train step), with the state each carries; an env
    that is neither a batched tensor env nor a host env pool is refused."""
    from repro_torch.core.agents import (DQNAgent, LaggedPAACAgent,
                                         PPOAgent)

    env = GridWorld(4, device="cpu")
    cfg = _vector_cfg(env)

    class OtherAgent(PAACAgent):
        pass

    for agent, state in ((OtherAgent(cfg), None), (PPOAgent(cfg), None),
                         (LaggedPAACAgent(cfg), {"stale", "since"}),
                         (DQNAgent(cfg), {"replay", "target", "updates"})):
        rl = ParallelRL(env, agent, replay_capacity=64, device="cpu")
        assert (rl.agent_state if state is None
                else set(rl.agent_state)) == state
        assert rl.run(1).steps == 4 * agent.hp.t_max
    with pytest.raises(NotImplementedError, match="HostEnvPool.*is neither"):
        ParallelRL(object(), PAACAgent(cfg), device="cpu")


def test_paper_atari_runs_two_iterations_on_the_cpu(capsys):
    results = paper_atari.main(["--device", "cpu", "--n-envs", "4",
                                "--iters", "2", "--arch", "paac_nature"])
    assert len(results) == 1 and results[0].steps == 2 * 4 * 5
    m = results[0].mean_metrics
    assert all(math.isfinite(v) for v in m.values())
    assert 0 < m["entropy"] <= math.log(3) + 1e-6
    assert "epoch 0: steps=     40" in capsys.readouterr().out

"""The port's mesh rollout plane against the JAX package's (CPU).

The mirrors of ``tests/test_mesh.py`` run on a ``RolloutMesh`` of CPU
lanes (``make_rollout_mesh(n, device="cpu")``, the counterpart of
``--xla_force_host_platform_device_count``), torch against torch:

* ``PipelineConfig``'s matrix of valid and invalid mesh settings, the
  rollout mesh's overflow message, a 1-axis mesh required by the ring;
* ``MeshTrajectoryRing``: a round trip that hands over the slot, per-lane
  back-pressure, ``close`` through a lane aborting every lane,
  ``producer_done`` per lane, the lanes' set (``Lanes`` of the lanes' own
  tensors in lane order, ``actor_id`` -1, the minimum behaviour version),
  ``get`` blocking until every lane has a payload, a closed lane ending
  the stream, a payload off its lane's device or in numpy refused, and a
  mesh payload refused by the host ``TrajectoryQueue``.

Against the reference:

* at D = 2, one ``make_sharded_learner_step`` against the reference's flat
  ``make_learner_step`` on the lanes' batch put side by side (T, 2E), from
  the same converted params, at clips (inf, inf) and (1, 1): params, loss,
  policy loss, value loss and entropy within ``rtol=1e-5, atol=1e-6``
  (``tests/test_mesh.py``'s bound);
* the split axes against ``repro.distributed.sharding``'s
  ``traj_sharding``/``batch_sharding``/``replicated_sharding`` specs on a
  1-device JAX mesh, and ``constrain``/``mesh_axis_size`` against
  ``repro.distributed.constraints``.

And the plane end to end: ``PipelinedRL`` at ``mesh_shape`` 1, lockstep,
depth 1, equal to the port's device plane bit for bit (clips inf and 1);
at ``mesh_shape`` 2 a lockstep run, a second run and per-lane env pools;
each update's V-trace through the K2 dispatch once a lane.
"""
import queue as stdq
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
from repro.distributed import constraints as ref_constraints  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import make_optimizer as jax_optimizer  # noqa: E402
from repro.pipeline.learner import \
    make_learner_step as jax_learner_step  # noqa: E402
from repro_torch.configs import PipelineConfig, get_config  # noqa: E402
from repro_torch.core.agents import PAACAgent, PAACConfig  # noqa: E402
from repro_torch.core.rollout import Transition  # noqa: E402
from repro_torch.distributed import (axis_context, batch_sharding,  # noqa: E402
                                     constrain, mesh_axis_size,
                                     replicated_sharding, traj_sharding)
from repro_torch.envs import (AtariLike, FrameStack, GridWorld,  # noqa: E402
                              narrow_vector_env)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import RolloutMesh, make_rollout_mesh  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.pipeline import (CLOSED, PipelinedRL, QueueClosed,  # noqa: E402
                                  Rollout, TrajectoryQueue)
from repro_torch.pipeline.learner import make_sharded_learner_step  # noqa: E402
from repro_torch.pipeline.ring import Lanes, MeshTrajectoryRing  # noqa: E402
from repro_torch.utils.bridge import params_from_numpy  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

INF = float("inf")


def _mesh(n):
    return make_rollout_mesh(n, device="cpu")


def _grid(n=8):
    return GridWorld(n, size=4, max_steps=20, device="cpu")


def _agent(env, t_max=5):
    cfg = get_config("paac_vector").replace(obs_shape=env.obs_shape,
                                            num_actions=env.num_actions)
    return PAACAgent(cfg, PAACConfig(t_max=t_max))


def _pipelined(env=None, seed=1, **cfg):
    env = env if env is not None else _grid()
    first = env[0] if isinstance(env, list) else env
    return PipelinedRL(env, _agent(first), lr_schedule=constant(0.01),
                       seed=seed, device="cpu",
                       pipeline=PipelineConfig(**cfg))


# ---------------------------------------------------------------------------
# config matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(mesh_shape=0),
    dict(mesh_shape=2, actor_backend="process"),
    dict(mesh_shape=2, rollout_plane="host"),
    dict(mesh_shape=2, rollout_plane="device"),
    dict(mesh_shape=2, num_actors=3),
    dict(actor_backend="process", rollout_plane="device"),
    dict(actor_backend="process", rollout_plane="mesh"),
    dict(mesh_shape=2, elastic=True),
])
def test_pipeline_config_rejects_invalid_combos(kw):
    with pytest.raises(ValueError):
        PipelineConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mesh_shape=2),
    dict(mesh_shape=4, num_actors=4),
    dict(mesh_shape=2, rollout_plane="mesh"),
    dict(rollout_plane="mesh"),  # 1-lane mesh: the bitwise-pin config
    dict(mesh_shape=2, lockstep=True),
])
def test_pipeline_config_accepts_valid_combos(kw):
    cfg = PipelineConfig(**kw)
    assert cfg.mesh_shape == kw.get("mesh_shape", 1)


def test_make_rollout_mesh_overflow_names_the_visible_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"only 1 device\(s\) visible"):
        make_rollout_mesh(2)
    mesh = make_rollout_mesh()  # every visible device
    assert mesh.devices == (torch.device("cuda", 0),)


def test_cpu_rollout_mesh_has_lanes_that_share_the_cpu():
    mesh = _mesh(3)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 3}
    assert len(_mesh(0).devices) == 1


def test_lockstep_with_several_actors_needs_the_mesh():
    with pytest.raises(ValueError, match="lockstep"):
        _pipelined(num_actors=2, lockstep=True)
    assert _pipelined(mesh_shape=2, lockstep=True)._n_actors == 2


def test_mesh1_plane_rejects_extra_actors():
    """rollout_plane='mesh' at mesh_shape 1 carries one lane — more actors
    are refused, not silently dropped."""
    with pytest.raises(ValueError, match="one actor lane per mesh"):
        _pipelined(num_actors=4, rollout_plane="mesh")


# ---------------------------------------------------------------------------
# the mesh ring
# ---------------------------------------------------------------------------


def _rollout_on(device, seq=0, t=3, e=2, obs=4, fill=1.0, version=0):
    """A Rollout on ``device`` with time-major (t, e, ...) leaves."""
    kw = dict(device=device)
    traj = Transition(
        obs=torch.full((t, e, obs), fill, **kw),
        action=torch.zeros((t, e), dtype=torch.int64, **kw),
        reward=torch.full((t, e), fill, **kw),
        done=torch.zeros((t, e), dtype=torch.bool, **kw),
        value=torch.zeros((t, e), **kw),
        logp=torch.zeros((t, e), **kw))
    return Rollout(traj, torch.full((e, obs), fill, **kw), version, 0, seq)


def test_mesh_ring_requires_data_axis_mesh():
    mesh = RolloutMesh((torch.device("cpu"),), ("data", "model"))
    with pytest.raises(ValueError, match="1-axis"):
        MeshTrajectoryRing(2, mesh)


def test_mesh1_ring_roundtrip_and_ownership():
    """A 1-lane ring: the lane's tensors come back untouched in the set,
    and the sub-ring's slot lets go of them."""
    ring = MeshTrajectoryRing(2, _mesh(1))
    sent = _rollout_on(ring.devices[0], seq=0, fill=3.0)
    ring.lane(0).put(sent)
    out = ring.get(timeout=5.0)
    assert isinstance(out, Rollout) and isinstance(out.traj, Lanes)
    assert out.seq == 0 and out.actor_id == -1 and out.release is None
    assert out.traj[0] is sent.traj and out.last_obs[0] is sent.last_obs
    assert ring.qsize() == 0
    assert ring._subs[0]._slots[0].payload is None
    assert ring.tickets_issued == [1] and ring.tickets_consumed == [1]


def test_mesh_ring_backpressure_blocks_per_lane():
    ring = MeshTrajectoryRing(1, _mesh(1))
    dev, lane = ring.devices[0], ring.lane(0)
    lane.put(_rollout_on(dev, seq=0))
    with pytest.raises(stdq.Full):
        lane.put(_rollout_on(dev, seq=1), timeout=0.05)
    assert lane.put_wait_s > 0.0
    ring.get(timeout=1.0)
    lane.put(_rollout_on(dev, seq=1), timeout=1.0)  # slot recycled


def test_mesh_ring_close_aborts_every_lane():
    ring = MeshTrajectoryRing(1, _mesh(2))
    dev = ring.devices[0]
    for i in range(2):
        ring.lane(i).put(_rollout_on(dev, seq=0))
    blocked = {}

    def producer():
        try:
            ring.lane(1).put(_rollout_on(dev, seq=1), timeout=30.0)
            blocked["result"] = "returned"
        except QueueClosed:
            blocked["result"] = "closed"

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.1)
    ring.lane(0).close()  # a lane's abort closes the whole ring
    t.join(timeout=5.0)
    assert blocked["result"] == "closed"
    assert isinstance(ring.get(timeout=1.0), Rollout)  # drain, then CLOSED
    assert ring.get(timeout=1.0) is CLOSED


def test_mesh_ring_rejects_host_payload():
    ring = MeshTrajectoryRing(2, _mesh(1))
    np_rollout = Rollout(Transition(*(np.zeros((2, 2)) for _ in range(6))),
                         np.zeros((2, 4)), 0, 0, 0)
    with pytest.raises(TypeError, match="host staging step"):
        ring.lane(0).put(np_rollout)


def test_mesh_ring_producer_done_is_per_lane():
    ring = MeshTrajectoryRing(2, _mesh(1))
    with pytest.raises(RuntimeError, match="lane"):
        ring.producer_done()
    ring.lane(0).producer_done()
    assert ring.get(timeout=1.0) is CLOSED


def test_mesh_ring_assembles_the_lanes_in_lane_order():
    """Two lanes' rollouts come out as one set: each field the lanes' own
    tensors in lane order, the worst lane's behaviour version, and put
    side by side the global (t, 2e) batch."""
    ring = MeshTrajectoryRing(2, _mesh(2))
    d0, d1 = ring.devices
    a = _rollout_on(d0, seq=0, fill=1.0, version=5)
    b = _rollout_on(d1, seq=0, fill=2.0, version=7)
    ring.lane(0).put(a)
    ring.lane(1).put(b)
    out = ring.get(timeout=5.0)
    assert out.seq == 0 and out.actor_id == -1
    assert out.behavior_version == 5  # min across lanes (worst staleness)
    assert out.traj[0] is a.traj and out.traj[1] is b.traj
    assert out.last_obs[0] is a.last_obs and out.last_obs[1] is b.last_obs
    r = torch.cat([t.reward for t in out.traj], dim=1)
    np.testing.assert_array_equal(r.numpy(), np.concatenate(
        [np.full((3, 2), 1.0), np.full((3, 2), 2.0)], axis=1))
    o = torch.cat(list(out.last_obs), dim=0)
    assert tuple(o.shape) == (4, 4)


def test_mesh_ring_get_blocks_until_every_lane_has_a_payload():
    ring = MeshTrajectoryRing(2, _mesh(2))
    d0, d1 = ring.devices
    first = _rollout_on(d0, seq=0)
    ring.lane(0).put(first)
    with pytest.raises(stdq.Empty):
        ring.get(timeout=0.05)  # lane 1 empty: no full set yet
    ring.lane(1).put(_rollout_on(d1, seq=0))
    out = ring.get(timeout=5.0)  # lane 0's payload was kept, not lost
    assert out.seq == 0 and out.traj[0] is first.traj


def test_mesh_ring_refuses_lanes_out_of_step():
    ring = MeshTrajectoryRing(2, _mesh(2))
    ring.lane(0).put(_rollout_on(ring.devices[0], seq=0))
    ring.lane(1).put(_rollout_on(ring.devices[1], seq=1))
    with pytest.raises(RuntimeError, match="desynchronized"):
        ring.get(timeout=5.0)


def test_mesh_ring_closed_lane_ends_the_stream():
    ring = MeshTrajectoryRing(2, _mesh(2))
    ring.lane(0).put(_rollout_on(ring.devices[0], seq=0))
    ring.lane(1).producer_done()  # lane 1 checks out without producing
    assert ring.get(timeout=5.0) is CLOSED  # the partial set is dropped


def test_mesh_lane_rejects_wrong_device_payload():
    """CPU lanes cannot be told apart, so the payload lives on ``meta``."""
    ring = MeshTrajectoryRing(2, _mesh(2))
    with pytest.raises(TypeError, match="mesh lane 0"):
        ring.lane(0).put(_rollout_on(torch.device("meta"), seq=0))


def test_mesh_rollout_rejected_on_host_plane():
    ring = MeshTrajectoryRing(2, _mesh(2))
    for i, d in enumerate(ring.devices):
        ring.lane(i).put(_rollout_on(d, seq=0))
    assembled = ring.get(timeout=5.0)
    q = TrajectoryQueue(depth=2)
    with pytest.raises(TypeError, match="mesh-plane rollout leaked"):
        q.put(assembled)
    q.put(Rollout(Transition(*(np.zeros((2, 2)) for _ in range(6))),
                  np.zeros((2, 4)), 0, 0, 0))  # a flat payload still passes


# ---------------------------------------------------------------------------
# the rules against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [1, 2, 3, 5])
def test_split_axes_are_the_references_specs(ndim):
    jmesh = jax.make_mesh((1,), ("data",))
    mesh = _mesh(1)
    assert replicated_sharding(mesh).spec == tuple(
        ref_sharding.replicated_sharding(jmesh).spec)
    assert batch_sharding(mesh, ndim).spec == tuple(
        ref_sharding.batch_sharding(jmesh, ndim).spec)
    if ndim < 2:
        for fn in (traj_sharding, ref_sharding.traj_sharding):
            with pytest.raises(ValueError, match=">= 2D"):
                fn(mesh if fn is traj_sharding else jmesh, ndim)
        return
    assert traj_sharding(mesh, ndim).spec == tuple(
        ref_sharding.traj_sharding(jmesh, ndim).spec)


def test_split_gives_lane_i_envs_i_e_to_i_plus_1_e():
    mesh = _mesh(2)
    x = torch.arange(3 * 8 * 2, dtype=torch.float32).reshape(3, 8, 2)
    parts = traj_sharding(mesh, 3).split(x)
    assert [tuple(p.shape) for p in parts] == [(3, 4, 2)] * 2
    assert torch.equal(parts[1], x[:, 4:])
    assert torch.equal(torch.cat(parts, dim=1), x)
    y = x[0]  # (8, 2), batch-leading
    b = batch_sharding(mesh, 2).split(y)
    assert torch.equal(b[0], y[:4]) and torch.equal(b[1], y[4:])
    assert all(p is x for p in replicated_sharding(mesh).split(x))
    # a tree: one tree a lane, the same structure, a lane on the leaf's
    # device holding the leaf itself (the learner's replicas)
    tree = {"w": x, "b": [y]}
    for rep in replicated_sharding(mesh).split(tree):
        assert rep["w"] is x and rep["b"][0] is y
    with pytest.raises(ValueError, match="cannot split 3 envs"):
        batch_sharding(mesh, 3).split(x)


def test_constrain_and_axis_size_off_and_on_the_mesh():
    x = torch.ones(4, 3)
    assert constrain(x, "data", None) is x
    assert ref_constraints.constrain(jnp.ones((4, 3)), "data", None) is not None
    assert mesh_axis_size("data") == ref_constraints.mesh_axis_size(
        "data") == 1
    with axis_context(_mesh(1)):
        with ref_constraints.axis_context(jax.make_mesh((1,), ("data",))):
            assert mesh_axis_size("data") == \
                ref_constraints.mesh_axis_size("data") == 1
            assert mesh_axis_size("model") == \
                ref_constraints.mesh_axis_size("model") == 1
    with axis_context(_mesh(4)):
        assert mesh_axis_size("data") == 4
        assert constrain(x, "data") is x
    assert mesh_axis_size("data") == 1


# ---------------------------------------------------------------------------
# the sharded learner step against the reference's flat step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clips", [(INF, INF), (1.0, 1.0)])
def test_mesh2_sharded_step_allclose_vs_replicated(clips):
    """One sharded step over two lanes against the reference's flat
    ``make_learner_step`` on the lanes' batch put side by side, from the
    same converted params: the n-step path (K1) at infinite clips and the
    V-trace path (K2) at 1."""
    rho_bar, c_bar = clips
    t, e, obs_dim, lr = 4, 8, 6, 0.01
    cfg_j = jax_config("paac_vector").replace(obs_shape=(obs_dim,),
                                              num_actions=3)
    cfg = get_config("paac_vector").replace(obs_shape=(obs_dim,),
                                            num_actions=3)
    pj = jax_init(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(0)
    batch = dict(
        obs=rng.standard_normal((t, e, obs_dim), dtype=np.float32),
        action=rng.integers(0, 3, (t, e)),
        reward=rng.standard_normal((t, e), dtype=np.float32),
        done=rng.random((t, e)) < 0.2,
        value=np.zeros((t, e), np.float32),
        logp=np.full((t, e), -1.1, np.float32))
    last_obs = rng.standard_normal((e, obs_dim), dtype=np.float32)
    jopt = jax_optimizer("rmsprop")
    flat = jax.jit(jax_learner_step(JPAACAgent(cfg_j, JPAACConfig(t_max=t)),
                                    jopt, jax_constant(lr), rho_bar=rho_bar,
                                    c_bar=c_bar))
    jtraj = JTransition(**{k: jnp.asarray(v.astype(np.int32)
                                          if k == "action" else v)
                           for k, v in batch.items()})
    p_flat, _, m_flat = flat(pj, jopt.init(pj), jtraj, jnp.asarray(last_obs),
                             jnp.int32(0))

    mesh = _mesh(2)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    opt = make_optimizer("rmsprop")
    traj = Transition(**{k: torch.from_numpy(v) for k, v in batch.items()})
    lanes = list(zip(*(traj_sharding(mesh, x.dim()).split(x) for x in traj)))
    traj_parts = Lanes(Transition(*lane) for lane in lanes)
    obs_parts = Lanes(batch_sharding(mesh, 2).split(
        torch.from_numpy(last_obs)))
    step = make_sharded_learner_step(
        PAACAgent(cfg, PAACConfig(t_max=t)), opt, constant(lr), mesh,
        rho_bar=rho_bar, c_bar=c_bar, fused_publish=False)
    reps, _, m_mesh = step(replicated_sharding(mesh).split(pt),
                           opt.init(pt), traj_parts, obs_parts, 0)
    for k in ("loss", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(m_mesh[k]), float(m_flat[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(m_mesh["reward_sum"]) == pytest.approx(
        float(m_flat["reward_sum"]), rel=1e-6)
    flat_leaves = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, p_flat))
    for rep in reps:
        got = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda x: x.numpy(), rep))
        assert len(got) == len(flat_leaves)
        for a, b in zip(got, flat_leaves):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_sharded_step_refuses_a_set_of_the_wrong_width():
    env = _grid()
    step = make_sharded_learner_step(_agent(env), make_optimizer("rmsprop"),
                                     constant(0.01), _mesh(2),
                                     fused_publish=False)
    with pytest.raises(ValueError, match="runs 2 lanes"):
        step([{}], None, [None], [None], 0)


# ---------------------------------------------------------------------------
# the plane end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clips", [(INF, INF), (1.0, 1.0)],
                         ids=["inf", "clip1"])
def test_mesh1_depth1_lockstep_bitwise_vs_device_plane(clips):
    """mesh_shape 1, lockstep, depth 1, through the whole mesh plane (the
    1-lane sub-ring, the set, the sharded step, the per-lane publish):
    the port's device plane's metrics and params bit for bit, over two
    runs."""
    rho_bar, c_bar = clips

    def make(plane):
        return _pipelined(queue_depth=1, rho_bar=rho_bar, c_bar=c_bar,
                          lockstep=True, rollout_plane=plane)

    dev, mesh = make("device"), make("mesh")
    assert mesh._plane == "mesh" and dev._plane == "device"
    for n in (10, 3):
        r_dev, r_mesh = dev.run(n), mesh.run(n)
        assert r_mesh.mean_metrics["staleness"] == 0.0
        assert r_mesh.steps == r_dev.steps
        for k in ("loss", "policy_loss", "value_loss", "entropy",
                  "reward_sum"):
            assert r_mesh.mean_metrics[k] == r_dev.mean_metrics[k], k
        for a, b in zip(tree_leaves(dev.params), tree_leaves(mesh.params)):
            assert torch.equal(a, b)
    assert mesh.learned_ids == [(-1, i) for i in range(3)]


def test_mesh2_end_to_end_lockstep():
    """mesh_shape 2: every update learns one rollout of each lane (zero
    staleness at lockstep, seqs 0..n-1 learned once), the lanes' replicas
    equal lane 0's params, and a second run goes on from them."""
    prl = _pipelined(queue_depth=1, lockstep=True, mesh_shape=2)
    assert prl._plane == "mesh" and prl._n_actors == 2
    before = [x.clone() for x in tree_leaves(prl.params)]
    res = prl.run(8)
    assert res.steps == 8 * 8 * 5  # both lanes' envs count
    assert res.mean_metrics["staleness"] == 0.0
    assert prl.learned_ids == [(-1, i) for i in range(8)]
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(prl.params)))
    for rep in prl._replicas:
        for a, b in zip(tree_leaves(rep), tree_leaves(prl.params)):
            assert torch.equal(a, b)
    res2 = prl.run(4)
    assert res2.steps == res.steps + 4 * 8 * 5


def test_mesh2_per_lane_env_pools():
    """A list of envs gives each lane its own full-width pool."""
    prl = _pipelined([_grid(4), _grid(4)], seed=0, queue_depth=1,
                     lockstep=True, mesh_shape=2, num_actors=2)
    res = prl.run(5)
    assert res.steps == 5 * 2 * 4 * 5


def test_mesh2_each_lane_runs_vtrace_through_the_k2_dispatch(monkeypatch):
    """At finite clips every update calls K2's dispatch once a lane, on
    the lane's shard (T, E/D), from the learner thread; unlocked, with a
    deeper ring, staleness stays within the depth and the lanes' one
    behind."""
    calls = []
    real = ops.vtrace_returns

    def spy(rewards, *a, **kw):
        calls.append(tuple(rewards.shape))
        return real(rewards, *a, **kw)

    monkeypatch.setattr(ops, "vtrace_returns", spy)
    prl = _pipelined(queue_depth=2, mesh_shape=2)
    prl.run(6)
    assert calls == [(5, 4)] * 12
    assert max(prl.staleness) <= 2 + 1



def test_the_trainers_mesh_leg_runs_sanitized():
    """``--pipeline --mesh 2 --sanitize locks,transfers``: the guarded
    learner step and the in-place probes on the per-lane publish pass,
    and the lock-order monitor finds no cycle."""
    from repro_torch.launch import train

    (res,) = train.main(["--arch", "paac_vector", "--device", "cpu",
                         "--pipeline", "--mesh", "2", "--n-envs", "8",
                         "--t-max", "3", "--iterations", "6", "--sanitize",
                         "locks,transfers"])
    assert res.steps == 6 * 8 * 3


def test_narrowed_env_lives_on_the_device_it_is_given():
    """``narrow_vector_env(..., device=)``: the copy and its wrapped env
    hold their tables on the device (``meta`` here, the CPU's only other
    device), the original stays where it was."""
    env = FrameStack(AtariLike(4, device="cpu"), 4)
    lane = narrow_vector_env(env, 2, device="meta")
    assert lane.n_envs == lane.env.n_envs == 2
    assert lane.device.type == lane.env.device.type == "meta"
    tables = [v for v in vars(lane.env).values()
              if isinstance(v, torch.Tensor)]
    assert tables and all(t.is_meta for t in tables)
    assert env.device.type == env.env.device.type == "cpu"
    assert not any(v.is_meta for v in vars(env.env).values()
                   if isinstance(v, torch.Tensor))


def test_the_trainers_single_env_mesh_leg_pins_each_lane(monkeypatch):
    """``--pipeline --mesh 2`` gives the plane one env; on lanes whose
    devices differ (``cpu`` and ``cpu:0``, which compute alike) each lane
    steps its own copy of that env on its own device, as a lane on
    ``cuda:i`` must, and the run trains."""
    from repro_torch.launch import train
    from repro_torch.pipeline import orchestrator

    lanes = RolloutMesh((torch.device("cpu"), torch.device("cpu", 0)))
    monkeypatch.setattr(orchestrator, "make_rollout_mesh",
                        lambda n, device="cuda": lanes)
    seen = []
    real = orchestrator.PipelinedRL._split_envs

    def spy(self, env, per_actor_envs, n_actors):
        out = real(self, env, per_actor_envs, n_actors)
        seen.append((env, out[0]))
        return out

    monkeypatch.setattr(orchestrator.PipelinedRL, "_split_envs", spy)
    (res,) = train.main(["--arch", "paac_vector", "--device", "cpu",
                         "--pipeline", "--mesh", "2", "--n-envs", "8",
                         "--t-max", "3", "--iterations", "4"])
    assert res.steps == 4 * 8 * 3
    ((env, envs),) = seen
    assert [e.device for e in envs] == list(lanes.devices)
    assert all(e.n_envs == 4 and e is not env for e in envs)

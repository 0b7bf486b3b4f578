"""The port's process actor plane (CPU, small shapes).

Mirrors of ``tests/test_process_actors.py``, torch against torch:

* ``ShmStagingSet`` is writable and readable across an attach boundary in
  ``staging_fields``'s layout (int64 actions), its tensors and numpy views
  are one memory, and attaching needs a name;
* ``ShmParamSlot`` speaks ``PingPongParamSlot``'s reserve/commit protocol
  with cross-process reader leases; its leaves are keyed by path, so a
  tree bridged from the JAX package (sorted keys) committed into a slot
  templated from the port's own tree (insertion order) reads back exactly,
  and a view reads the params onto the card unless asked for the CPU;
* a run never drops a rollout (every ``(actor_id, seq)`` learned once), a
  spec is sharded across workers, zero-quota workers check out;
* a seeded single-worker lockstep run at infinite clips learns from the
  same rollout stream as the thread host plane: parameters, metrics and
  the acting generator's state bitwise equal;
* a crash inside a worker surfaces as the actor error without deadlock;
  live pools and the device plane are refused with the reference's texts;
  ``close`` is idempotent and reaps the workers, and leaves no segment of
  the plane in ``/dev/shm``; the workers' span rings reach the hub, and
  a shipped ring merges as the reference hub merges it (its clock guard).

Against the reference: one learner update on a payload read back from a
``ShmStagingSet`` (what the parent's drainer queues) equals the
reference's update on the same numpy rollout, at clips 1 (V-trace, K2's
plain version here) and at infinite clips (n-step, K1's), within rtol
1e-4 atol 1e-5 (``tests/test_torch_rl.py``'s tolerance).

Every env recipe comes from ``repro_torch.envs.pyemu`` (module-level
constructors): spawn ships specs by pickle reference. Torch's intra-op
threads are capped at 2 here, and the plane hands that cap to its
children. A spawned child costs about 3.4 s here, most of it ``import
torch``.
"""
import multiprocessing as mp
import os
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
from repro_torch.core.agents import PAACAgent, PAACConfig  # noqa: E402
from repro_torch.envs import HostEnvPool, HostEnvSpec, py_bound_spec  # noqa: E402
from repro_torch.envs.pyemu import make_py_bound_env  # noqa: E402
from repro_torch.models import init_policy  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.pipeline import (PipelinedRL, ShmParamSlot,  # noqa: E402
                                  ShmParamView, ShmStagingSet)
from repro_torch.pipeline.actor import staging_fields, to_device  # noqa: E402
from repro_torch.pipeline.learner import make_learner_step  # noqa: E402
from repro_torch.utils.bridge import (params_from_numpy,  # noqa: E402
                                      params_to_numpy)
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

INF = float("inf")


def _vector_agent(obs_dim=4, t_max=3):
    cfg = get_config("paac_vector").replace(obs_shape=(obs_dim,),
                                            num_actions=3)
    return PAACAgent(cfg, PAACConfig(t_max=t_max))


def _spec(n, obs_dim=4, n_workers=2, **kw):
    return py_bound_spec(n, obs_dim=obs_dim, spin=0, n_workers=n_workers,
                         device="cpu", **kw)


def _pipe(**kw):
    base = dict(queue_depth=2, actor_backend="process")
    base.update(kw)
    return PipelineConfig(**base)


def _process(env, agent, seed=0, **kw):
    return PipelinedRL(env, agent, lr_schedule=constant(0.01), seed=seed,
                       pipeline=_pipe(**kw), device="cpu")


def _shm_names():
    return set(os.listdir("/dev/shm"))


# ------------------------------------------------- shm staging set
def test_shm_staging_set_roundtrips_across_attach():
    parent = ShmStagingSet(t_max=2, n_envs=3, obs_shape=(4,),
                           obs_dtype=np.float32)
    try:
        assert parent.traj.obs.shape == (2, 3, 4)
        assert parent.traj.action.dtype == torch.int64
        assert parent.np_traj.action.dtype == np.int64
        assert parent.traj.done.dtype == torch.bool
        assert parent.last_obs.shape == (3, 4)
        assert [(tuple(t.shape), t.numpy().dtype) for t in
                parent.traj + (parent.last_obs,)] == staging_fields(
                    2, 3, (4,), np.float32)
        child = ShmStagingSet(t_max=2, n_envs=3, obs_shape=(4,),
                              obs_dtype=np.float32, name=parent.name,
                              create=False)
        # writes through one mapping are visible through the other — the
        # zero-copy contract the drainer's Rollout wrapping relies on
        child.np_traj.obs[1, 2] = 7.0
        child.traj.reward[0] = torch.tensor([1.0, 2.0, 3.0])
        child.np_last_obs[:] = 5.0
        child.traj.action[1, 0] = 2
        np.testing.assert_array_equal(parent.traj.obs[1, 2].numpy(),
                                      np.full(4, 7.0))
        np.testing.assert_array_equal(parent.np_traj.reward[0],
                                      [1.0, 2.0, 3.0])
        np.testing.assert_array_equal(parent.last_obs.numpy(),
                                      np.full((3, 4), 5.0))
        assert int(parent.np_traj.action[1, 0]) == 2
        child.close()
    finally:
        parent.close()
        parent.unlink()


def test_shm_staging_set_attach_requires_name():
    with pytest.raises(ValueError):
        ShmStagingSet(1, 1, (), np.float32, create=False)


def test_shm_staging_set_close_survives_live_views():
    s = ShmStagingSet(2, 2, (3,), np.float32)
    view = s.traj.obs  # a live tensor over the mapping
    s.close()  # BufferError swallowed: the mapping stays while view lives
    assert view.shape == (2, 2, 3)
    s.unlink()
    assert s.name.lstrip("/") not in _shm_names()


# ------------------------------------------------- shm param slot
def test_shm_param_slot_reserve_commit_and_leases():
    ctx = mp.get_context("spawn")
    tree = {"w": np.arange(4, dtype=np.float32), "b": np.zeros(2, np.float32)}
    slot = ShmParamSlot(tree, ctx, version=0)
    try:
        view = ShmParamView(slot.handle(), 0, device="cpu")
        params, v = view.read_params()
        assert v == 0
        np.testing.assert_array_equal(params["w"].numpy(),
                                      np.arange(4, dtype=np.float32))
        # a held lease on buffer v % 2 blocks reserve(v + 2), not v + 1
        _, v0 = view.acquire()
        assert not slot.reserve(2, timeout=0.1)  # buffer 0 leased
        assert slot.reserve(1, timeout=0.1)      # buffer 1 free
        with pytest.raises(RuntimeError, match="reserve timed out"):
            slot.publish({"w": np.ones(4, np.float32),
                          "b": np.ones(2, np.float32)}, 2, timeout=0.1)
        view.release(v0)
        slot.publish({"w": torch.full((4,), 9.0),
                      "b": torch.ones(2)}, 2, timeout=1.0)
        assert view.wait_for(2, timeout=1.0)
        params, v = view.read_params()
        assert v == 2
        np.testing.assert_array_equal(params["w"].numpy(),
                                      np.full(4, 9.0, np.float32))
        assert not view.wait_for(3, timeout=0.05)
        view.close()
    finally:
        slot.close()
        slot.unlink()


def test_shm_param_slot_names_and_revokes_a_holder():
    ctx = mp.get_context("spawn")
    slot = ShmParamSlot({"w": torch.zeros(3)}, ctx, max_readers=4)
    try:
        view = ShmParamView(slot.handle(), reader_id=2, device="cpu")
        _, v = view.acquire()
        assert slot.holders(v % 2) == ["worker 2"]
        with pytest.raises(RuntimeError, match="leased by worker 2"):
            slot.publish({"w": torch.ones(3)}, 2, timeout=0.05)
        assert slot.revoke(2) == 1
        view.release(v)  # revoked under it: a no-op, still balanced
        slot.publish({"w": torch.ones(3)}, 2, timeout=1.0)
        assert slot.holders(0) == []
        view.close()
    finally:
        slot.close()
        slot.unlink()


def test_shm_param_view_puts_params_on_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    slot = ShmParamSlot({"w": np.zeros(3, np.float32)}, mp.get_context("spawn"))
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShmParamView(slot.handle(), 0)
    finally:
        slot.close()
        slot.unlink()


def test_shm_param_slot_keys_leaves_by_path():
    """A reference tree bridged into the port has sorted keys; the slot's
    template is the port's own tree (insertion order). Committed by path,
    it reads back leaf for leaf exactly."""
    cfg_j = jax_config("paac_vector").replace(obs_shape=(4,), num_actions=3)
    cfg = get_config("paac_vector").replace(obs_shape=(4,), num_actions=3)
    own = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    bridged = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_init(jax.random.PRNGKey(3), cfg_j)), "cpu")
    own_paths = [p for p, _ in tree_paths(own)]
    assert own_paths != [p for p, _ in tree_paths(bridged)]
    assert sorted(own_paths) == sorted(p for p, _ in tree_paths(bridged))
    slot = ShmParamSlot(own, mp.get_context("spawn"))
    try:
        view = ShmParamView(slot.handle(), 0, device="cpu")
        slot.publish(bridged, 1)
        got, v = view.read_params()
        assert v == 1
        assert [p for p, _ in tree_paths(got)] == own_paths
        want = dict(tree_paths(bridged))
        for path, leaf in tree_paths(got):
            assert torch.equal(leaf, want[path]), path
        view.close()
    finally:
        slot.close()
        slot.unlink()


def test_shipped_spans_merge_with_the_references_clock_guard():
    """A worker's shipped ring joins the hub under its process track; its
    timestamps stay as they are on a shared monotonic clock and are
    re-anchored when the shipped clock sample is over 1 s away, as the
    reference hub does."""
    from repro.telemetry import Telemetry as JTelemetry
    from repro_torch.telemetry import SpanEmitter, Telemetry
    from repro_torch.telemetry.spans import COLLECT

    em = SpanEmitter("worker0")
    t = time.perf_counter()
    em.record(COLLECT, t - 0.5)
    shipped = em.ship()
    for skew in (0.0, 100.0):
        payload = dict(shipped, clock=shipped["clock"] - skew)
        got = Telemetry().merge_shipped(payload, pid=1)
        want = JTelemetry().merge_shipped(payload, pid=1)
        (c, t0, t1), = got.snapshot()
        (wc, wt0, _), = want.snapshot()
        assert (got.name, c, got.total(COLLECT)) == (
            want.name, wc, want.total(COLLECT))
        assert abs(t0 - wt0) < 0.5
        assert (abs(t0 - (t - 0.5)) < 1e-9) == (skew == 0.0)
        assert abs(t1 - t0 - 0.5) < 0.05


# ------------------------------------------------- end to end
def test_process_backend_end_to_end_never_drops():
    agent = _vector_agent()
    with _process(_spec(4), agent) as prl:
        res = prl.run(5)
        assert res.steps == 5 * 4 * 3
        assert np.isfinite(res.mean_metrics["loss"])
        assert sorted(prl.learned_ids) == [(0, s) for s in range(5)]
        # the workers persist across runs: a second run reuses them
        pids = [w.proc.pid for w in prl._process_plane._workers]
        res2 = prl.run(3)
        assert res2.steps == 8 * 4 * 3
        assert sorted(prl.learned_ids) == [(0, s) for s in range(3)]
        assert [w.proc.pid for w in prl._process_plane._workers] == pids
        # the worker's span ring reached the hub on its own process track
        tracks = {(pid, em.name) for pid, _, em in prl.telemetry.tracks()}
        assert (1, "worker0") in tracks and (0, "shm.publish") in tracks
        worker = next(em for pid, _, em in prl.telemetry.tracks() if pid == 1)
        cats = {worker.categories[c] for c, _, _ in worker.snapshot()}
        assert {"collect", "shm.copy"} <= cats


def test_process_backend_multi_worker_spec_shard():
    """A single spec is sharded across workers (each child builds its own
    slice pool); every (actor_id, seq) is learned exactly once."""
    agent = _vector_agent()
    with _process(_spec(8, n_workers=4), agent, num_actors=2) as prl:
        assert [s.n_envs for s in prl._proc_specs] == [4, 4]
        assert [s.n_workers for s in prl._proc_specs] == [2, 2]
        res = prl.run(6)
    assert res.steps == 6 * 4 * 3  # 4-env shards, not 8
    assert sorted(prl.learned_ids) == [(a, s) for a in range(2)
                                       for s in range(3)]
    assert len(res.per_actor_idle_s) == 2


def test_process_backend_zero_quota_workers_check_out():
    """iterations < num_actors: quota-0 workers check out cleanly (no
    hang) and the stream still delivers every tagged rollout."""
    specs = [_spec(2, obs_dim=3, base_seed=10 * a) for a in range(3)]
    agent = _vector_agent(obs_dim=3, t_max=2)
    # no lr_schedule: the paper's rule reads a replica's n_envs
    with PipelinedRL(specs, agent, pipeline=_pipe(num_actors=3),
                     device="cpu") as prl:
        assert prl.env is specs[0]
        t0 = time.perf_counter()
        res = prl.run(2)  # quota [1, 1, 0]
        assert time.perf_counter() - t0 < 120.0
    assert res.steps == 2 * 2 * 2
    assert sorted(prl.learned_ids) == [(0, 0), (1, 0)]


def test_process_lockstep_bitwise_matches_thread_host_plane():
    """Seeded single-worker lockstep with infinite clips: the subprocess
    collects the same rollout stream the thread host plane does (the same
    acting generator, the same params through shm), so learning matches
    bitwise — params, metrics and the synced generator state — across two
    run() calls."""
    def run_backend(backend):
        with _process(_spec(4), _vector_agent(), seed=1, queue_depth=1,
                      rho_bar=INF, c_bar=INF, lockstep=True,
                      actor_backend=backend) as prl:
            res = [prl.run(6), prl.run(3)]
            return (res, [t.clone() for t in tree_leaves(prl.params)],
                    prl._actor_keys[0][0].get_state())

    r_t, p_t, g_t = run_backend("thread")
    r_p, p_p, g_p = run_backend("process")
    for a, b in zip(r_t, r_p):
        assert b.mean_metrics["staleness"] == 0.0
        assert a.mean_metrics == b.mean_metrics
    assert all(torch.equal(a, b) for a, b in zip(p_t, p_p))
    assert torch.equal(g_t, g_p)


# ------------------------------------------------- lifecycle
def test_worker_env_crash_propagates_without_deadlock():
    # obs_dim < 0 makes np.full raise inside the worker's first reset
    spec = HostEnvSpec(env_fn=make_py_bound_env, env_args=((0, -1, 0),),
                       n_workers=1, obs_shape=(1,), device="cpu")
    prl = _process(spec, _vector_agent(obs_dim=1, t_max=2))
    try:
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="actor 0 failed") as e:
            prl.run(4)
        assert "negative dimensions" in str(e.value.__cause__)
        assert time.perf_counter() - t0 < 120.0  # unwound, not deadlocked
    finally:
        prl.close()


def test_process_backend_rejects_live_pools_and_device_plane():
    agent = _vector_agent(obs_dim=1, t_max=2)
    with HostEnvPool([lambda s=0: None], n_workers=1, obs_shape=(1,),
                     device="cpu") as pool:
        with pytest.raises(ValueError, match="requires a HostEnvSpec") as e:
            PipelinedRL(pool, agent, pipeline=_pipe(), device="cpu")
        assert "a live HostEnvPool cannot be shipped to a child" in str(
            e.value)
    spec = _spec(2, obs_dim=1, n_workers=1)
    with pytest.raises(ValueError, match="host"):
        PipelinedRL(spec, agent, pipeline=_pipe(rollout_plane="device"),
                    device="cpu")
    with pytest.raises(ValueError, match="actor_backend"):
        PipelinedRL(spec, agent, device="cpu",
                    pipeline=PipelineConfig(actor_backend="fork"))


def test_close_is_idempotent_and_reaps_workers():
    prl = _process(_spec(2, obs_dim=2, n_workers=1),
                   _vector_agent(obs_dim=2, t_max=2))
    procs = [w.proc for w in prl._process_plane._workers]
    prl.run(2)
    prl.close()
    prl.close()  # idempotent
    assert all(not p.is_alive() for p in procs)
    assert prl._process_plane is None


def test_close_leaves_no_segment_in_dev_shm():
    prl = _process(_spec(4, n_workers=1), _vector_agent(), num_actors=2)
    try:
        mine = prl._process_plane.segment_names()
        # two workers x (depth 2 + 2) staging sets, two param buffers
        assert len(mine) == 2 * 4 + 2
        assert set(mine) <= _shm_names()
        prl.run(4)
    finally:
        prl.close()
    assert not set(mine) & _shm_names()


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("clips", [(1.0, 1.0), (INF, INF)],
                         ids=["vtrace", "inf"])
def test_update_on_a_shm_payload_matches_the_reference(clips):
    """What the parent's learner does with a process payload — the staging
    set's tensors, copied to the device — against the reference's update
    on the same numpy rollout, with bridged params."""
    T, E, obs_dim, lr = 5, 6, 4, 0.003
    rng = np.random.default_rng(7)
    cfg_j = jax_config("paac_vector").replace(obs_shape=(obs_dim,),
                                              num_actions=3)
    cfg = get_config("paac_vector").replace(obs_shape=(obs_dim,),
                                            num_actions=3)
    pj = jax_init(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    roll = dict(obs=rng.normal(size=(T, E, obs_dim)).astype(np.float32),
                action=rng.integers(0, 3, (T, E)),
                reward=rng.normal(size=(T, E)).astype(np.float32),
                done=rng.random((T, E)) < 0.2,
                value=rng.normal(size=(T, E)).astype(np.float32),
                logp=np.log(rng.uniform(0.2, 0.6, (T, E))).astype(np.float32))
    last = rng.normal(size=(E, obs_dim)).astype(np.float32)
    parent = ShmStagingSet(T, E, (obs_dim,), np.float32)
    child = ShmStagingSet(T, E, (obs_dim,), np.float32, name=parent.name,
                          create=False)
    try:
        for f, a in roll.items():  # the child's writes, in place
            np.copyto(getattr(child.np_traj, f), a)
        np.copyto(child.np_last_obs, last)
        child.close()
        hp_j, hp = JPAACConfig(t_max=T), PAACConfig(t_max=T)
        opt_j, opt = jax_optimizer("rmsprop"), make_optimizer("rmsprop")
        step_j = jax.jit(jax_learner_step(JPAACAgent(cfg_j, hp_j), opt_j,
                                          jax_constant(lr), rho_bar=clips[0],
                                          c_bar=clips[1]))
        traj_j = JTransition(**{f: jnp.asarray(a) for f, a in roll.items()})
        traj_j = traj_j._replace(action=traj_j.action.astype(jnp.int32))
        new_j, _, m_j = step_j(pj, opt_j.init(pj), traj_j, jnp.asarray(last),
                               jnp.int32(0))
        step = make_learner_step(PAACAgent(cfg, hp), opt, constant(lr),
                                 rho_bar=clips[0], c_bar=clips[1])
        traj, last_obs = to_device(parent.traj, parent.last_obs, "cpu")
        new_t, _, m_t = step(pt, opt.init(pt), traj, last_obs, 0)
        for k in ("loss", "policy_loss", "value_loss", "entropy", "rho_mean",
                  "reward_sum", "episodes"):
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(new_t)),
                        jax.tree_util.tree_leaves(new_j)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-5)
        # the update read the payload and left it as it was
        np.testing.assert_array_equal(parent.np_traj.obs, roll["obs"])
    finally:
        del traj, last_obs
        parent.close()
        parent.unlink()

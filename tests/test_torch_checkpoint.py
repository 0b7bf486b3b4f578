"""The port's checkpointer and the pipeline's checkpoint/resume (CPU, small
shapes).

Mirrors of ``tests/test_checkpoint.py`` and of ``tests/test_optim.py``'s
round trip, torch against torch:

* tree round-trips keep each leaf's type, dtype and device: bf16 tensors
  come back bf16 **bitwise** (saved as lossless f32), numpy leaves stay
  numpy, Python scalars keep their type, and the json manifest records
  each leaf's logical dtype; generator states come back in place;
* ``latest_step`` is anchored: prefix look-alikes never shadow the series;
* kill a lock-stepped pipelined run mid-flight and resume from its newest
  checkpoint: at depth 1 and infinite clips the resumed run's params,
  optimizer state, ``total_steps`` and seq numbering equal the
  uninterrupted run's bit for bit (and at clips 1, V-trace's path, too);
* the host plane resumes warm (params and counters exact) and keeps going.

Across the packages: a file the reference's ``save_checkpoint`` writes
from numpy params (an MLP tree, fp32 and bf16 leaves) restores in the port
into ``params_from_numpy(..., "cpu")``'s tree bitwise, a file the port
writes restores in the reference bitwise, and both manifests hold the same
keys and logical dtypes.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpointer as ref_ckpt  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro_torch.checkpoint import (latest_step, restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import PipelineConfig, get_config  # noqa: E402
from repro_torch.core.agents import PAACAgent, PAACConfig  # noqa: E402
from repro_torch.envs import GridWorld, HostEnvPool  # noqa: E402
from repro_torch.pipeline import FaultPlan, PipelinedRL  # noqa: E402
from repro_torch.utils.bridge import params_from_numpy  # noqa: E402
from repro_torch.utils.tree import (tree_leaves, tree_map,  # noqa: E402
                                    tree_paths)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint8).numpy() if t.dim() else \
        t.reshape(1).view(torch.uint8).numpy()


# ---------------------------------------------------------------------------
# checkpointer round-trips
# ---------------------------------------------------------------------------


def test_bf16_roundtrip_is_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {
        "w": torch.randn(16, 8, generator=g).to(torch.bfloat16),
        "b": torch.arange(8, dtype=torch.bfloat16) / 3,
        "f32": torch.randn(4, generator=g),
    }
    save_checkpoint(str(tmp_path), 1, tree)
    back = restore_checkpoint(str(tmp_path), 1, tree)
    for k in tree:
        assert back[k].dtype == tree[k].dtype, k
        assert back[k].device == tree[k].device, k
        np.testing.assert_array_equal(_bits(back[k]), _bits(tree[k]),
                                      err_msg=k)


def test_scalar_and_numpy_leaves_roundtrip(tmp_path):
    gen = torch.Generator().manual_seed(7)
    tree = {
        "step": 42,
        "lr": 0.125,
        "host_obs": np.arange(6, dtype=np.float32).reshape(2, 3),
        "counters": np.asarray([3, 5], np.int64),
        "gen": gen,
    }
    want = gen.get_state().clone()
    save_checkpoint(str(tmp_path), 3, tree)
    torch.rand(5, generator=gen)  # move the generator on
    back = restore_checkpoint(str(tmp_path), 3, tree)
    assert back["step"] == 42 and isinstance(back["step"], int)
    assert back["lr"] == 0.125 and isinstance(back["lr"], float)
    # numpy stays numpy: a host-plane resume must not move it to a device
    assert type(back["host_obs"]) is np.ndarray
    np.testing.assert_array_equal(back["host_obs"], tree["host_obs"])
    np.testing.assert_array_equal(back["counters"], tree["counters"])
    assert back["gen"] is gen and torch.equal(gen.get_state(), want)


def test_manifest_records_logical_dtypes(tmp_path):
    tree = {"w": torch.zeros(2, dtype=torch.bfloat16), "n": 7,
            "g": torch.Generator()}
    save_checkpoint(str(tmp_path), 2, tree, prefix="pipe")
    with open(os.path.join(str(tmp_path), "pipe_0000000002.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 2
    assert manifest["keys"] == ["g", "n", "w"]
    assert manifest["dtypes"]["w"] == "bfloat16"
    assert manifest["dtypes"]["g"] == "uint8"


def test_latest_step_is_anchored(tmp_path):
    for name in ("pipe_0000000003.npz", "pipe_0000000001.npz",
                 "pipe_extra_0000000009.npz", "xpipe_0000000008.npz"):
        (tmp_path / name).write_bytes(b"")
    assert latest_step(str(tmp_path), prefix="pipe") == 3
    assert latest_step(str(tmp_path), prefix="nope") is None
    assert latest_step(str(tmp_path / "missing")) is None


def test_restore_rejects_shape_mismatch(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": np.zeros((4,), np.float32),
                                       "t": torch.zeros(3)})
    with pytest.raises(AssertionError):
        restore_checkpoint(str(tmp_path), 1,
                           {"w": np.zeros((5,), np.float32),
                            "t": torch.zeros(3)})
    with pytest.raises(AssertionError, match="t"):
        restore_checkpoint(str(tmp_path), 1,
                           {"w": np.zeros((4,), np.float32),
                            "t": torch.zeros(2, 2)})


def test_checkpoint_roundtrip(tmp_path):
    """``tests/test_optim.py``'s round trip: nested, int and bf16 leaves,
    ``latest_step`` on the default prefix."""
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(4, 5, generator=g),
            "nested": {"b": torch.arange(7),
                       "c": torch.ones(2, dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 42, tree)
    assert latest_step(str(tmp_path)) == 42
    target = {"a": torch.empty(4, 5),
              "nested": {"b": torch.empty(7, dtype=torch.int64),
                         "c": torch.empty(2, dtype=torch.bfloat16)}}
    restored = restore_checkpoint(str(tmp_path), 42, target)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_generator_states_round_trip(tmp_path):
    """A generator leaf saves its state and restores it into the target
    generator itself; the draws after the restore repeat those after the
    save. A list of generators keys by index."""
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    for g in gens:
        torch.rand(3, generator=g)
    save_checkpoint(str(tmp_path), 5, {"gens": gens})
    after = [torch.rand(4, generator=g) for g in gens]
    fresh = [torch.Generator(), torch.Generator()]
    back = restore_checkpoint(str(tmp_path), 5, {"gens": fresh})
    assert back["gens"][0] is fresh[0] and back["gens"][1] is fresh[1]
    for f, want in zip(fresh, after):
        assert torch.equal(torch.rand(4, generator=f), want)
    with np.load(tmp_path / "ckpt_0000000005.npz") as data:
        assert sorted(data.files) == ["gens::0", "gens::1"]
        assert data["gens::0"].dtype == np.uint8


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _mlp_numpy_tree():
    """The reference's paac_vector params as numpy (an MLP tree, fp32),
    plus a bf16 copy of two leaves."""
    cfg = jax_config("paac_vector").replace(obs_shape=(6,), num_actions=3)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_init(jax.random.PRNGKey(3), cfg))
    paths = [p for p, _ in tree_paths(params)]
    assert not any("convs" in p for p in paths)  # no layout to permute
    bf16 = {"w16": np.asarray(jnp.asarray(params["heads"]["policy"]["w"],
                                          jnp.bfloat16)),
            "b16": np.asarray(jnp.asarray(params["trunk"]["dense"]["b"],
                                          jnp.bfloat16))}
    return {"params": params, "half": bf16}


def test_reference_file_restores_in_the_port_bitwise(tmp_path):
    np_tree = _mlp_numpy_tree()
    jax_tree = jax.tree_util.tree_map(jnp.asarray, np_tree)
    ref_ckpt.save_checkpoint(str(tmp_path), 11, jax_tree, prefix="x")
    target = params_from_numpy(np_tree, "cpu")
    back = restore_checkpoint(str(tmp_path), 11,
                              tree_map(torch.zeros_like, target),
                              prefix="x")
    n = 0
    for (pa, a), (pb, b) in zip(tree_paths(target), tree_paths(back)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=str(pa))
        n += 1
    assert n == len(jax.tree_util.tree_leaves(np_tree))
    assert back["half"]["w16"].dtype == torch.bfloat16


def test_port_file_restores_in_the_reference_bitwise(tmp_path):
    np_tree = _mlp_numpy_tree()
    save_checkpoint(str(tmp_path), 12, params_from_numpy(np_tree, "cpu"),
                    prefix="x")
    target = jax.tree_util.tree_map(lambda a: jnp.zeros_like(jnp.asarray(a)),
                                    np_tree)
    back = ref_ckpt.restore_checkpoint(str(tmp_path), 12, target, prefix="x")
    flat_want = dict(tree_paths(np_tree))
    for path, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        key = tuple(k.key for k in path)
        want = flat_want[key]
        got = np.asarray(leaf)
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8), err_msg=str(key))


def test_manifests_hold_the_same_keys_and_dtypes(tmp_path):
    np_tree = _mlp_numpy_tree()
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 1,
                             jax.tree_util.tree_map(jnp.asarray, np_tree))
    save_checkpoint(str(tmp_path / "port"), 1,
                    params_from_numpy(np_tree, "cpu"))
    ref_m, port_m = (json.loads((tmp_path / d / "ckpt_0000000001.json")
                                .read_text()) for d in ("ref", "port"))
    assert port_m == ref_m
    assert port_m["dtypes"]["half::w16"] == "bfloat16"
    with np.load(tmp_path / "ref" / "ckpt_0000000001.npz") as r, \
            np.load(tmp_path / "port" / "ckpt_0000000001.npz") as p:
        assert sorted(r.files) == sorted(p.files) == port_m["keys"]


# ---------------------------------------------------------------------------
# pipeline checkpoint/resume
# ---------------------------------------------------------------------------


def _grid_rl(tmp_dir="", every=0, fault_plan=None, seed=1, clip=None):
    env = GridWorld(8, size=4, max_steps=20, device="cpu")
    cfg = get_config("paac_vector").replace(
        obs_shape=env.obs_shape, num_actions=env.num_actions)
    agent = PAACAgent(cfg, PAACConfig(t_max=5))
    clip = float("inf") if clip is None else clip
    return PipelinedRL(
        env, agent, seed=seed, device="cpu",
        pipeline=PipelineConfig(
            queue_depth=1, rho_bar=clip, c_bar=clip, lockstep=True,
            checkpoint_dir=str(tmp_dir), checkpoint_every=every,
            fault_plan=fault_plan),
    )


@pytest.mark.parametrize("clip", [None, 1.0], ids=["inf", "clips1"])
def test_kill_and_resume_is_bitwise_vs_uninterrupted(tmp_path, clip):
    """Run A uninterrupted; run B checkpoints every 3 updates and is killed
    by an injected fault; run C restores B's newest checkpoint and runs the
    remainder. Under depth-1 lockstep C's params equal A's bit for bit (at
    infinite clips through the n-step path, at clips 1 through V-trace)."""
    total = 8
    rl_a = _grid_rl(clip=clip)
    rl_a.run(total)

    rl_b = _grid_rl(tmp_dir=tmp_path, every=3, clip=clip,
                    fault_plan=FaultPlan(kills=((0, 5, "error"),)))
    with pytest.raises(RuntimeError):
        rl_b.run(total)
    assert latest_step(str(tmp_path), prefix="pipe") == 3

    rl_c = _grid_rl(tmp_dir=tmp_path, clip=clip)
    done = rl_c.restore()
    assert done == 3
    assert rl_c.total_steps == rl_b._steps_per_iter * 3
    res = rl_c.run(total - done)
    assert np.isfinite(res.mean_metrics["loss"])
    for a, c in zip(tree_leaves(rl_a.params), tree_leaves(rl_c.params)):
        assert torch.equal(a, c)
    for a, c in zip(tree_leaves(rl_a.opt_state), tree_leaves(rl_c.opt_state)):
        assert torch.equal(a, c)
    assert rl_c.total_steps == rl_a.total_steps
    # seq numbering continued where the consumed stream left off
    assert [s for _, s in rl_c.learned_ids] == list(range(3, total))
    # and the generators stand where the uninterrupted run's do
    for ga, gc in zip(rl_a._actor_keys[0], rl_c._actor_keys[0]):
        assert torch.equal(ga.get_state(), gc.get_state())


def test_resume_with_empty_dir_is_noop(tmp_path):
    rl = _grid_rl(tmp_dir=tmp_path)
    assert rl.restore() == 0
    with pytest.raises(ValueError, match="checkpoint dir"):
        _grid_rl().restore()


def test_periodic_checkpoints_accumulate(tmp_path):
    rl = _grid_rl(tmp_dir=tmp_path, every=2)
    rl.run(5)
    # checkpoints at updates 2 and 4; latest wins
    assert latest_step(str(tmp_path), prefix="pipe") == 4
    names = sorted(n for n in os.listdir(tmp_path) if n.endswith(".npz"))
    assert names == ["pipe_0000000002.npz", "pipe_0000000004.npz"]


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


def test_host_plane_checkpoint_and_warm_resume(tmp_path):
    """Host pool: the env state lives inside the pool's envs, so a resume
    is warm — params, optimizer state and counters restore exactly, the
    carried obs from its copied snapshot, and the run keeps going."""
    cfg = get_config("paac_vector").replace(obs_shape=(1,), num_actions=3)
    agent = PAACAgent(cfg, PAACConfig(t_max=3))

    def pool():
        return HostEnvPool([lambda s=i: _ToyGymEnv(s) for i in range(4)],
                           n_workers=2, obs_shape=(1,), device="cpu")

    with pool() as p:
        rl = PipelinedRL(
            p, agent, seed=0, device="cpu",
            pipeline=PipelineConfig(queue_depth=2,
                                    checkpoint_dir=str(tmp_path),
                                    checkpoint_every=2))
        rl.run(4)
        saved = [t.clone() for t in tree_leaves(rl.params)]
    with pool() as p:
        rl2 = PipelinedRL(
            p, agent, seed=0, device="cpu",
            pipeline=PipelineConfig(queue_depth=2,
                                    checkpoint_dir=str(tmp_path)))
        done = rl2.restore()
        assert done == 4
        for a, b in zip(saved, tree_leaves(rl2.params)):
            assert torch.equal(a, b)
        assert type(rl2._actor_obs[0]) is np.ndarray
        res = rl2.run(2)
    assert np.isfinite(res.mean_metrics["loss"])
    assert rl2.total_steps == 6 * 4 * 3

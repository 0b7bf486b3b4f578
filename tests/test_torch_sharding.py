"""The port's parameter, cache and input sharding rules against the JAX
package's (CPU).

For all ten ``ASSIGNED_ARCHS`` at every published width (the depth cut
to a few layers: the rules read a leaf's trailing dims, and a stack's
layer axes get ``None``):

* ``param_specs`` on both production meshes in ``tp``, ``fsdp_tp`` and
  ``zero1``, leaf by leaf by path, against ``repro.distributed.sharding``
  on a duck-typed mesh (the reference's own test builds an
  ``AbstractMesh`` with a signature this jax lacks, F2); the port's tree
  is built on fake tensors, the reference's with ``jax.eval_shape``;
* ``cache_specs`` at ``decode_32k`` and ``long_500k`` (the reference's
  ``adjust_cfg``: a window of 8192 on the attention archs), after the
  caches' paths and shapes are found equal;
* ``input_sharding`` on every shape's inputs;
* the mirrors of ``tests/test_sharding.py``'s invariants on the port's
  meshes: every sharded dim divides its axes, the MoE experts over
  ``"model"``, per-device parameter bytes under ``fsdp_tp`` from the full
  depth's per-layer bytes, the cache's batch and head rules, the batch
  only when it divides, the pod axis; and ``to_placements``.
"""
import functools
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import ASSIGNED_ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.specs import input_specs as ref_input_specs  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.launch.dryrun import adjust_cfg as ref_adjust_cfg  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.models import init_policy_cache as jax_cache  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES,  # noqa: E402
                                 get_config)
from repro_torch.data import input_specs  # noqa: E402
from repro_torch.distributed.sharding import (SHARDING_MODES,  # noqa: E402
                                              cache_specs, input_sharding,
                                              param_specs, shard_shape,
                                              spec_leaves, to_placements)
from repro_torch.launch.dryrun import adjust_cfg  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import init_policy, init_policy_cache  # noqa: E402
from repro_torch.utils.tree import tree_paths  # noqa: E402

MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}


def ref_mesh(mesh):
    """The duck-typed mesh the reference's rules read (F2)."""
    return SimpleNamespace(shape=dict(mesh.shape),
                           axis_names=tuple(mesh.axis_names))


def cut(cfg):
    """``cfg`` at every published width with the fewest layers that keep
    each kind of stack: a dense first layer and one more for an MoE
    model, one hybrid group and a tail, two encoder layers."""
    kw = {"num_layers": cfg.first_dense_layers + 1}
    if cfg.family == "hybrid":
        kw["num_layers"] = cfg.shared_attn_every + 1
    if cfg.is_encoder_decoder:
        kw.update(num_layers=2, encoder_layers=2)
    return cfg.replace(**kw)


def fake_tree(fn):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return fn()


@functools.lru_cache(maxsize=None)
def port_params(arch):
    cfg = cut(get_config(arch))
    return cfg, fake_tree(lambda: init_policy(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    cfg = cut(jax_config(arch))
    return jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), cfg))


def ref_by_path(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join(keys)] = leaf
    return out


def port_by_path(tree):
    """path -> leaf of a port's tree (tensors or spec tuples)."""
    out = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, pre + [str(k)])
        else:
            out["/".join(pre)] = t

    walk(tree, [])
    return out


def same_specs(port, ref):
    assert set(port) == set(ref), (sorted(set(port) ^ set(ref)))
    for path in ref:
        assert port[path] == tuple(ref[path]), (path, port[path], ref[path])


def test_the_registry_is_the_references():
    assert ASSIGNED_ARCHS == REF_ARCHS
    assert SHARDING_MODES == ref_sharding.SHARDING_MODES


@pytest.mark.parametrize("mode", ["tp", "fsdp_tp", "zero1"])
@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_equal_the_references(arch, mesh_id, mode):
    mesh = MESHES[mesh_id]
    _, params = port_params(arch)
    port = port_by_path(param_specs(params, mesh, mode))
    ref = ref_by_path(ref_sharding.param_specs(ref_params(arch),
                                               ref_mesh(mesh), mode))
    same_specs(port, ref)


def cache_pair(arch, shape_name):
    shp = INPUT_SHAPES[shape_name]
    cfg = adjust_cfg(cut(get_config(arch)), shape_name)
    rcfg = ref_adjust_cfg(cut(jax_config(arch)), shape_name)
    if cfg is None:
        assert rcfg is None
        return None, None
    B, S = shp.global_batch, shp.seq_len
    cache = fake_tree(lambda: init_policy_cache(cfg, B, S, device="cpu"))
    rcache = jax.eval_shape(lambda: jax_cache(rcfg, B, S))
    return cache, rcache


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_specs_equal_the_references(arch, shape_name, mesh_id):
    mesh = MESHES[mesh_id]
    cache, rcache = cache_pair(arch, shape_name)
    if cache is None:  # the speech encoder-decoder skips long_500k
        assert shape_name == "long_500k"
        return
    port_shapes = port_by_path(cache)
    ref_shapes = ref_by_path(rcache)
    assert {k: tuple(v.shape) for k, v in port_shapes.items()} == \
        {k: tuple(v.shape) for k, v in ref_shapes.items()}
    port = port_by_path(cache_specs(cache, mesh))
    ref = ref_by_path(ref_sharding.cache_specs(rcache, ref_mesh(mesh)))
    same_specs(port, ref)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_sharding_equals_the_references(arch, mesh_id):
    mesh = MESHES[mesh_id]
    for shape_name in INPUT_SHAPES:
        port = input_sharding(input_specs(get_config(arch), shape_name),
                              mesh)
        ref = ref_sharding.input_sharding(
            ref_input_specs(jax_config(arch), shape_name), ref_mesh(mesh))
        same_specs(port, ref_by_path(ref))


# ---------------------------------------------------------------------------
# mirrors of tests/test_sharding.py, on the port's meshes
# ---------------------------------------------------------------------------


def axis_size(mesh, a):
    sizes = dict(mesh.shape)
    if a is None:
        return 1
    if isinstance(a, tuple):
        n = 1
        for x in a:
            n *= sizes[x]
        return n
    return sizes[a]


@pytest.mark.parametrize("mode", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_divisible(arch, mesh_id, mode):
    """Every sharded dim divides its mesh axes (no silent padding)."""
    mesh = MESHES[mesh_id]
    _, params = port_params(arch)
    specs = port_by_path(param_specs(params, mesh, mode))
    leaves = {"/".join(map(str, p)): t for p, t in tree_paths(params)}
    n_sharded = 0
    for path, spec in specs.items():
        leaf = leaves[path]
        assert len(spec) == leaf.ndim
        for dim, a in zip(leaf.shape, spec):
            s = axis_size(mesh, a)
            if s > 1:
                n_sharded += 1
                assert dim % s == 0, (path, leaf.shape, spec)
    assert n_sharded > 0  # something shards


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "dbrx-132b",
                                  "deepseek-coder-33b"])
def test_fsdp_bounds_per_device_param_bytes(arch):
    """``fsdp_tp`` puts each model's parameters on 256 devices at <= 6 GB a
    device, the reference's bound: the cut tree's per-layer bytes scaled
    to the published depth."""
    mesh = MESHES["16x16"]
    full = get_config(arch)
    cfg, params = port_params(arch)
    specs = param_specs(params, mesh, "fsdp_tp")
    per_device = 0.0
    for (path, leaf), spec in zip(tree_paths(params), spec_leaves(specs)):
        nbytes = (torch.Size(shard_shape(leaf.shape, spec, mesh)).numel()
                  * leaf.element_size())
        if path[1] in ("layers",):  # the stack the cut shortened
            nbytes *= (full.num_layers - full.first_dense_layers) / (
                cfg.num_layers - cfg.first_dense_layers)
        per_device += nbytes
    assert 0 < per_device < 6e9, f"{per_device / 1e9:.2f} GB a device"


def test_moe_experts_shard_over_model():
    _, params = port_params("dbrx-132b")
    specs = param_specs(params, MESHES["16x16"], "fsdp_tp")
    assert specs["trunk"]["layers"]["moe"]["wi"] == (None, "model", "data",
                                                     None)


def test_cache_specs_batch_and_heads():
    cfg = get_config("deepseek-coder-33b")
    cache = fake_tree(lambda: init_policy_cache(cfg, 128, 1024,
                                                device="cpu"))
    k_spec = cache_specs(cache, MESHES["16x16"])["layers"]["attn"]["k"]
    assert k_spec[1] == "data"  # (L, B, S, Hkv, D)
    assert k_spec[3] is None  # kv 8 heads do not divide model 16


def test_input_sharding_batch_only_when_divisible():
    batch = {"tokens": torch.empty((256, 4097), dtype=torch.int32,
                                   device="meta"),
             "one": torch.empty((1, 5), device="meta")}
    sh = input_sharding(batch, MESHES["16x16"])
    assert sh["tokens"][0] == "data"
    assert sh["one"] == (None, None)


def test_multipod_data_axes():
    batch = {"tokens": torch.empty((256, 4097), dtype=torch.int32,
                                   device="meta")}
    assert input_sharding(batch, MESHES["2x16x16"])["tokens"][0] == \
        ("pod", "data")


def test_meshes_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert MESHES["16x16"].shape == {"data": 16, "model": 16}
    assert MESHES["2x16x16"].axis_names == ("pod", "data", "model")
    assert make_host_mesh().shape == {"data": 1, "model": 1}
    dm = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert to_placements((("pod", "data"), None, "model"), dm) == (
        Shard(0), Shard(0), Shard(2))
    assert to_placements({"a": (None, None)}, dm) == {
        "a": (Replicate(), Replicate(), Replicate())}
    assert shard_shape((64, 7, 32), (("pod", "data"), None, "model"),
                       MESHES["2x16x16"]) == (2, 7, 2)
    # the rules on the host mesh shard nothing
    _, params = port_params("glm4-9b")
    specs = spec_leaves(param_specs(params, make_host_mesh(), "fsdp_tp"))
    assert all(a is None for spec in specs for a in spec)

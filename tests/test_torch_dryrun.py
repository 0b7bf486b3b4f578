"""The port's dry-run plane against the JAX package's (CPU).

* ``input_specs``: the shapes and dtypes of every architecture's inputs at
  every input shape equal the reference's ``ShapeDtypeStruct``s;
* ``active_params`` and ``model_flops`` equal the reference's to a
  relative 1e-9 on trees at every published width (the depth cut: the
  count is a sum over leaves), the port's built on fake tensors;
* ``roofline_terms`` divides by the H100's peaks;
* ``constrain`` hands a plain tensor back unchanged, on a mesh and off;
* ``lower_pair`` on reduced configs (2 layers, narrow widths) of a dense,
  an MLA, an MoE and an SSM model on fake meshes of (1, 1) and (2, 4), at
  small input shapes added for the test: on (1, 1) no collective runs,
  the fallback gathers nothing, and the FLOPs equal ``FlopCounterMode``'s
  count of the same step unsharded and the bytes a direct sum over its
  ops; on (2, 4) the devices' summed FLOPs are at least that count, and
  for the SSM exactly it plus the value head the model axis replicates;
  under ``tp`` the all-reduces a layer of the dense model's decode adds
  are pinned; one train step runs on (2, 4);
* ``LocalCostMode`` counts one device's shards of a sharded product, not
  the global product;
* ``mfu_params`` leaves out an untied embedding table.

A module fixture makes the ``"fake"`` process group (8 ranks) and
destroys it at teardown, so no other file in the worker sees a group.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.specs import input_specs as ref_input_specs  # noqa: E402
from repro.launch import analysis as ref_analysis  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES,  # noqa: E402
                                 InputShape, get_config)
from repro_torch.data import input_specs, step_kind  # noqa: E402
from repro_torch.distributed.constraints import (axis_context,  # noqa: E402
                                                 constrain)
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW,  # noqa: E402
                                     PEAK_FLOPS_BF16, ProductionMesh,
                                     make_host_mesh)
from repro_torch.launch.steps import (build_prefill_step,  # noqa: E402
                                      build_serve_step)
from repro_torch.models import init_policy, init_policy_cache  # noqa: E402

DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32,
          jnp.bool_: torch.bool}
# small global shapes for the reduced pairs (the published ones run in
# ``python -m repro_torch.launch.dryrun``)
TEST_SHAPES = {"train_t": InputShape("train_t", 16, 8, "train"),
               "prefill_t": InputShape("prefill_t", 64, 8, "prefill"),
               "decode_t": InputShape("decode_t", 64, 8, "decode")}
# each kind's arch and the shape its pairs run
ARCHS = {"dense": ("glm4-9b", "decode_t"),
         "mla": ("minicpm3-4b", "prefill_t"),
         "moe": ("dbrx-132b", "prefill_t"),
         "ssm": ("mamba2-370m", "prefill_t")}
MESHES = {"1x1": (1, 1), "2x4": (2, 4)}


@pytest.fixture(scope="module")
def fake_group():
    """The fake group and the test meshes built on it (built once, so
    DTensor's propagation cache serves every test of a mesh)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield {k: ProductionMesh(v, ("data", "model")).build()
           for k, v in MESHES.items()}
    dist.destroy_process_group()


@pytest.fixture
def test_shapes(monkeypatch):
    for name, shape in TEST_SHAPES.items():
        monkeypatch.setitem(INPUT_SHAPES, name, shape)


def fake(fn):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return fn()


def cut(cfg):
    """Every published width, few layers (the counts sum over leaves)."""
    kw = {"num_layers": cfg.first_dense_layers + 1}
    if cfg.family == "hybrid":
        kw["num_layers"] = cfg.shared_attn_every + 1
    if cfg.is_encoder_decoder:
        kw.update(num_layers=2, encoder_layers=2)
    return cfg.replace(**kw)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_equal_the_references(arch):
    for shape_name in INPUT_SHAPES:
        port = input_specs(get_config(arch), shape_name)
        ref = ref_input_specs(jax_config(arch), shape_name)
        assert list(port) == list(ref)
        for k, v in ref.items():
            assert tuple(port[k].shape) == tuple(v.shape), (shape_name, k)
            assert port[k].dtype == DTYPES[v.dtype.type], (shape_name, k)
            assert port[k].device.type == "meta"
        assert step_kind(shape_name) == INPUT_SHAPES[shape_name].kind


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_equal_the_references(arch):
    cfg = cut(get_config(arch))
    rcfg = cut(jax_config(arch))
    params = fake(lambda: init_policy(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    sds = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), rcfg))
    ref_n = ref_analysis.active_params(rcfg, sds)
    assert analysis.active_params(cfg, params) == pytest.approx(ref_n,
                                                                rel=1e-9)
    tokens = 256 * 4096
    assert analysis.model_flops(cfg, params, tokens) == pytest.approx(
        ref_analysis.model_flops(rcfg, sds, tokens), rel=1e-9)


def test_roofline_terms_use_the_h100():
    assert (PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)
    t = analysis.roofline_terms(989e12, 2 * 3.35e12, 0.5 * 450e9)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["bottleneck"] == "memory"


def test_constrain_returns_a_plain_tensor(fake_group):
    x = torch.ones(4, 6)
    assert constrain(x, "data", "model") is x  # no mesh
    with axis_context(make_host_mesh()):  # a mesh without a DeviceMesh
        assert constrain(x, "data", "model") is x
    with axis_context(fake_group["2x4"]):
        assert constrain(x, "data", "model") is x


class ByteSum(TorchDispatchMode):
    """Each op's distinct tensor operands plus its results, in bytes; views,
    ops that make uninitialised or no data, and ops on the meta device
    move nothing."""

    FREE = {"empty", "empty_strided", "empty_like", "new_empty",
            "new_empty_strided", "detach", "device"}

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if (func.is_view or func._overloadpacket.__name__ in self.FREE
                or (outs and all(t.device.type == "meta" for t in outs))):
            return out
        seen = {id(t): t for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor)}
        self.bytes += sum(t.numel() * t.element_size() for t in seen.values())
        return out


def unsharded_counts(cfg, shape_name):
    """(``FlopCounterMode``'s FLOPs, ``ByteSum``'s bytes) of the step on
    plain fake tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    shp = INPUT_SHAPES[shape_name]

    def run():
        params = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in input_specs(cfg, shape_name).items()}
        if shp.kind != "prefill":
            cache = init_policy_cache(cfg, shp.global_batch, shp.seq_len,
                                      device="cpu")
        counter, nbytes = FlopCounterMode(display=False), ByteSum()
        with counter, nbytes, torch.no_grad():
            if shp.kind == "prefill":
                build_prefill_step(cfg)(params, batch)
            else:
                build_serve_step(cfg)(params, cache, batch["token"],
                                      shp.seq_len - 1, torch.Generator())
        return counter.get_total_flops(), nbytes.bytes

    return fake(run)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("kind", list(ARCHS))
def test_lower_pair_runs(kind, mesh_id, fake_group, test_shapes):
    arch, shape_name = ARCHS[kind]
    cfg = get_config(arch).reduced()
    mesh = fake_group[mesh_id]
    rep = dryrun.lower_pair(arch, shape_name, cfg=cfg, mesh=mesh,
                            measure_peak=False)
    assert rep["chips"] == mesh.size and rep["kind"] == shape_name[:-2]
    assert rep["flops_per_chip"] > 0 and rep["bytes_per_chip"] > 0
    assert rep["memory_analysis"]["argument_bytes"] > 0
    flops, nbytes = unsharded_counts(cfg, shape_name)
    if mesh.size == 1:
        assert rep["collective_counts"] == {}
        assert rep["collectives"]["total_wire_bytes"] == 0
        assert all(v["gathered_bytes"] == 0
                   for v in rep["replicated_ops"].values())
        assert rep["flops_per_chip"] == flops
        assert rep["bytes_per_chip"] == nbytes
    else:
        assert sum(rep["collective_counts"].values()) > 0
        assert rep["flops_per_chip"] * rep["chips"] >= flops
    if kind == "ssm" and mesh.size > 1:
        # every product is sharded but the value head's (d_model -> 1),
        # which each device of the model axis computes for its data shard
        shp = INPUT_SHAPES[shape_name]
        value = 2 * shp.global_batch * shp.seq_len * cfg.d_model
        model = dict(mesh.shape)["model"]
        assert rep["flops_per_chip"] * rep["chips"] == flops + (
            model - 1) * value


def test_local_cost_mode_counts_one_devices_shards(fake_group):
    """A (8, 16) @ (16, 32) product with rows on the data axis and columns
    on the model axis of (2, 4): each device multiplies (4, 16) by
    (16, 8), so it counts that product's FLOPs and bytes, and no
    collective."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.trace_analysis import LocalCostMode

    dm = fake_group["2x4"].device_mesh

    def run():
        a = distribute_tensor(torch.zeros(8, 16), dm, [Shard(0), Replicate()])
        w = distribute_tensor(torch.zeros(16, 32), dm, [Replicate(), Shard(1)])
        mode = LocalCostMode()
        with mode:
            out = a @ w
        assert tuple(out.to_local().shape) == (4, 8)
        return mode.report()

    rep = fake(run)
    assert rep["flops"] == 2 * 4 * 16 * 8
    assert rep["bytes"] == 4 * (4 * 16 + 16 * 8 + 4 * 8)
    assert rep["collective_counts"] == {}


@pytest.mark.parametrize("tied", [False, True])
def test_mfu_params_leave_out_the_embedding(tied):
    cfg = get_config("glm4-9b").reduced().replace(tie_policy_head=tied)
    params = fake(lambda: init_policy(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    n = analysis.active_params(cfg, params)
    embed = cfg.vocab_size * cfg.d_model
    assert analysis.mfu_params(cfg, params) == (n if tied else n - embed)


def test_tp_all_reduces_a_layer(fake_group, test_shapes):
    """Under ``tp`` on (2, 4) each decode layer of the reduced dense model
    after the first adds five all-reduces: two in the MLP, one before the
    value projection, and the K and V cache writes (its 2 KV heads do not
    divide the 4-way model axis)."""
    mesh = fake_group["2x4"]
    counts = []
    for layers in (2, 3):
        cfg = get_config("glm4-9b").reduced().replace(num_layers=layers)
        rep = dryrun.lower_pair("glm4-9b", "decode_t", cfg=cfg, mesh=mesh,
                                sharding_mode="tp", measure_peak=False)
        counts.append(rep["collective_counts"]["all_reduce"])
    assert counts[1] - counts[0] == 5


def test_lower_pair_trains(fake_group, test_shapes):
    cfg = get_config("glm4-9b").reduced()
    rep = dryrun.lower_pair("glm4-9b", "train_t", cfg=cfg,
                            mesh=fake_group["2x4"])
    assert rep["kind"] == "train"
    assert rep["collective_counts"].get("reduce_scatter", 0) + \
        rep["collective_counts"].get("all_reduce", 0) > 0
    assert rep["memory_analysis"]["peak_bytes"] is None or \
        rep["memory_analysis"]["peak_bytes"] > 0
    assert rep["model_flops_global"] == pytest.approx(
        6 * analysis.active_params(cfg, fake(lambda: init_policy(
            cfg, generator=torch.Generator().manual_seed(0),
            device="cpu"))) * 8 * 16)


def test_skip_and_adjust_follow_the_reference():
    seamless = get_config("seamless-m4t-large-v2")
    assert dryrun.skip_reason(seamless, "long_500k")
    assert dryrun.lower_pair("seamless-m4t-large-v2", "long_500k")[
        "skipped"]
    assert dryrun.adjust_cfg(get_config("glm4-9b"), "long_500k"
                             ).sliding_window == dryrun.SWA_WINDOW
    assert dryrun.adjust_cfg(get_config("mamba2-370m"), "long_500k"
                             ).sliding_window == 0

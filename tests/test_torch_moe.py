"""The port's MoE block and MoE trunks against the JAX package's (CPU, fp32).

* **Routing** — ``_route_group`` on the same logits and tokens: the slot
  metadata (``slot``, ``inv_tok``) and the dispatch buffer equal to the
  reference's, the combine weights (``top_w`` and their slot-major copy
  ``w_slot``, whose empty slots are equal) and the aux loss within 1e-6;
  driven by hypothesis over the reference's strategy
  (``tests/test_moe.py``), plus a row of equal logits for the tie order.
* **The block** — ``moe_forward`` on the reference's ``init_moe``
  parameters carried across by the bridge, within the reference's 2e-4:
  capacity factors 0.1 (tokens drop), 1.25 and 16, shared experts on and
  off, a decode step (the batch is one group), rows as groups and
  sequence chunks; a ragged chunk refused as the reference refuses it.
  The reference's invariants re-run on the port, and the gather combine
  against the scatter-add formulation.
* **Trunks** — reduced deepseek-v2-236b's dense first stack before its
  MoE layers; the bridge keeps the (L, E, in, out) expert stacks as they
  are, and the port's init gives the reference's tree with an fp32
  router. The whole reduced trunks against JAX are in
  ``tests/test_torch_models.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ArchConfig as JArchConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import ArchConfig, get_config  # noqa: E402
from repro_torch.models import init_policy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.mlp import mlp_forward  # noqa: E402
from repro_torch.utils.bridge import params_from_numpy  # noqa: E402

try:  # hypothesis is a dev-extra; the fixed cases below run without it
    import hypothesis.strategies as st
    from hypothesis import given, settings
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False

MOE_TOL = 2e-4  # tests/test_moe.py's
ROUTE_TOL = 1e-6


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _moe_cfgs(E=4, k=2, d=32, ff=64, shared=0, cf=1.25, group=4096):
    kw = dict(name="t", family="moe", d_model=d, num_experts=E,
              num_experts_per_tok=k, moe_d_ff=ff, num_shared_experts=shared,
              param_dtype="float32", compute_dtype="float32",
              moe_capacity_factor=cf, moe_group_size=group)
    return JArchConfig(**kw), ArchConfig(**kw)


def _route_both(tokens, logits, k, capacity, E):
    ref = jmoe._route_group(jnp.asarray(tokens), jnp.asarray(logits), k=k,
                            capacity=capacity, E=E)
    got = tmoe._route_group(torch.from_numpy(tokens),
                            torch.from_numpy(logits), k, capacity, E)
    return ref, got


def _assert_route_equal(ref, got, E, capacity):
    buf, slot, top_w, aux, inv_tok, w_slot = got
    np.testing.assert_array_equal(slot.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(inv_tok.numpy(), np.asarray(ref[4]))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(ref[0]))
    # w_slot holds top_w's values: the same empty slots, the weights as
    # close as the two softmaxes (an ulp apart)
    np.testing.assert_array_equal(w_slot.numpy() == 0, np.asarray(ref[5]) == 0)
    _close(w_slot, ref[5], ROUTE_TOL)
    assert tuple(buf.shape) == (E, capacity, buf.shape[-1])
    _close(top_w, ref[2], ROUTE_TOL)
    _close(aux, ref[3], ROUTE_TOL)


def _check_route(seed, T, E, k, d=16):
    rng = np.random.default_rng(seed)
    capacity = max(int(np.ceil(T * k * 1.25 / E)), 1)
    tokens = rng.standard_normal((T, d)).astype(np.float32)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    ref, got = _route_both(tokens, logits, k, capacity, E)
    _assert_route_equal(ref, got, E, capacity)


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("seed,T,E,k", [(0, 4, 2, 1), (1, 64, 8, 2),
                                        (2, 33, 4, 2)])
def test_route_group_equals_the_reference(seed, T, E, k):
    _check_route(seed, T, E, k)


if HAVE_HYPOTHESIS:
    @settings(deadline=None, max_examples=20)
    @given(seed=st.integers(0, 1000), T=st.integers(4, 64),
           E=st.sampled_from([2, 4, 8]), k=st.sampled_from([1, 2]))
    def test_route_group_equals_the_reference_property(seed, T, E, k):
        _check_route(seed, T, E, k)


def test_route_group_breaks_ties_towards_the_lower_expert():
    T, E, k, d, capacity = 8, 4, 2, 16, 3  # 16 assignments, 12 slots
    tokens = np.random.default_rng(3).standard_normal((T, d)).astype(np.float32)
    logits = np.zeros((T, E), np.float32)
    ref, got = _route_both(tokens, logits, k, capacity, E)
    _assert_route_equal(ref, got, E, capacity)
    slot = got[1].numpy()
    # every token picks experts 0 then 1; the first three tokens fill them
    assert (slot[:3] == [[0, capacity], [1, capacity + 1],
                         [2, capacity + 2]]).all()
    assert (slot[3:] == E * capacity).all()


def test_route_group_takes_leading_group_axes():
    rng = np.random.default_rng(4)
    G, T, E, k, d, capacity = 3, 10, 4, 2, 8, 4
    tokens = rng.standard_normal((G, T, d)).astype(np.float32)
    logits = rng.standard_normal((G, T, E)).astype(np.float32)
    batched = tmoe._route_group(torch.from_numpy(tokens),
                                torch.from_numpy(logits), k, capacity, E)
    for g in range(G):
        one = tmoe._route_group(torch.from_numpy(tokens[g]),
                                torch.from_numpy(logits[g]), k, capacity, E)
        for a, b in zip(batched, one):
            assert torch.equal(a[g], b)


# ---------------------------------------------------------------- the block
def _params(cfg_j, seed=0):
    pj = jmoe.init_moe(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")


@pytest.mark.parametrize("cf", [0.1, 1.25, 16.0])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("B,S_,group", [(2, 8, 4096), (4, 1, 4096),
                                        (2, 32, 16)],
                         ids=["rows", "decode", "chunks"])
def test_moe_forward_matches_the_reference(cf, shared, B, S_, group):
    cfg_j, cfg = _moe_cfgs(shared=shared, cf=cf, group=group)
    pj, pt = _params(cfg_j)
    x = np.random.default_rng(5).standard_normal(
        (B, S_, cfg.d_model)).astype(np.float32)
    y_j, aux_j = jmoe.moe_forward(pj, cfg_j, jnp.asarray(x))
    y, aux = tmoe.moe_forward(pt, cfg, torch.from_numpy(x))
    assert y.shape == (B, S_, cfg.d_model) and y.dtype == torch.float32
    _close(y, y_j, MOE_TOL)
    _close(aux, aux_j, MOE_TOL)


def test_tokens_drop_at_a_small_capacity_and_both_sides_agree():
    cfg_j, cfg = _moe_cfgs(cf=0.1)
    pj, pt = _params(cfg_j)
    x = np.random.default_rng(6).standard_normal(
        (1, 64, cfg.d_model)).astype(np.float32)
    capacity = max(int(np.ceil(64 * 2 * 0.1 / 4)), 1)
    logits = torch.from_numpy(x[0]) @ pt["router"]["w"]
    slot = tmoe._route_group(torch.from_numpy(x[0]), logits, 2, capacity,
                             4)[1]
    assert (slot == 4 * capacity).sum() > 64  # most assignments drop
    y_j, _ = jmoe.moe_forward(pj, cfg_j, jnp.asarray(x))
    _close(tmoe.moe_forward(pt, cfg, torch.from_numpy(x))[0], y_j, MOE_TOL)


def test_a_ragged_sequence_chunk_is_refused_as_the_reference_does():
    cfg_j, cfg = _moe_cfgs(group=16)
    pj, pt = _params(cfg_j)
    x = np.zeros((1, 24, cfg.d_model), np.float32)
    with pytest.raises(AssertionError, match="not divisible"):
        jmoe.moe_forward(pj, cfg_j, jnp.asarray(x))
    with pytest.raises(ValueError, match="not divisible"):
        tmoe.moe_forward(pt, cfg, torch.from_numpy(x))


# the reference's invariants (tests/test_moe.py) on the port
def test_single_expert_equals_the_dense_expert():
    _, cfg = _moe_cfgs(E=1, k=1, cf=2.0)
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    y, _ = tmoe.moe_forward(p, cfg, x)
    h = torch.nn.functional.silu(x @ p["wi"][0]) * (x @ p["wg"][0])
    _close(y, h @ p["wo"][0], MOE_TOL)


def test_capacity_drops_tokens():
    _, cfg = _moe_cfgs(cf=0.1)
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((1, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    y_small, _ = tmoe.moe_forward(p, cfg, x)
    y_big, _ = tmoe.moe_forward(p, cfg.replace(moe_capacity_factor=8.0), x)
    assert float((y_small - y_big).abs().max()) > 1e-3


def test_shared_experts_are_added():
    _, cfg = _moe_cfgs(E=2, k=1, shared=1, cf=8.0)
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert "shared" in p
    x = torch.randn((1, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    y, _ = tmoe.moe_forward(p, cfg, x)
    y_no, _ = tmoe.moe_forward({k: v for k, v in p.items() if k != "shared"},
                               cfg, x)
    _close(y - y_no, mlp_forward(p["shared"], x), MOE_TOL)


@pytest.mark.parametrize("k", [2, 3])
def test_gather_combine_equals_the_scatter_add(k):
    """moe_forward's combine against the reference's formulation: every
    slot's weighted expert output scatter-added into its token's row."""
    _, cfg = _moe_cfgs(E=4, k=k, shared=1, cf=1.0)
    p = tmoe.init_moe(torch.Generator().manual_seed(2), cfg, torch.float32)
    x = torch.randn((1, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    T, E, d = 32, 4, cfg.d_model
    capacity = int(np.ceil(T * k * 1.0 / E))
    buf, _, _, _, inv_tok, w_slot = tmoe._route_group(
        x[0], x[0] @ p["router"]["w"], k, capacity, E)
    h = torch.nn.functional.silu(buf @ p["wi"]) * (buf @ p["wg"])
    out = (h @ p["wo"]).reshape(E * capacity, d)
    y = torch.zeros(T + 1, d).index_add_(0, inv_tok, out * w_slot[:, None])
    y = y[:T] + mlp_forward(p["shared"], x[0])
    got, _ = tmoe.moe_forward(p, cfg, x)
    _close(got[0], y, 1e-6)


# ---------------------------------------------------------------- trunks
def _pair(arch, **change):
    cfg_j = jax_config(arch).reduced().replace(**change)
    cfg = get_config(arch).reduced().replace(**change)
    pj = jax_init(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return cfg_j, cfg, pj, pt


def test_deepseek_trunk_has_a_dense_first_stack_before_the_moe_layers():
    cfg_j, cfg, pj, pt = _pair("deepseek-v2-236b")
    trunk = pt["trunk"]
    assert cfg.first_dense_layers == 1
    assert "mlp" in trunk["first"] and "moe" not in trunk["first"]
    assert tuple(trunk["first"]["mlp"]["wi"]["w"].shape) == (
        1, cfg.d_model, cfg.dense_d_ff)
    assert "moe" in trunk["layers"] and "mlp" not in trunk["layers"]


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-236b"])
def test_bridge_and_port_init_keep_the_reference_moe_tree(arch):
    cfg_j, cfg, pj, pt = _pair(arch)
    ref = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), pj)
    shapes = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), pt)
    assert shapes == ref
    moe_j, moe_t = pj["trunk"]["layers"]["moe"], pt["trunk"]["layers"]["moe"]
    L = cfg.num_layers - cfg.first_dense_layers
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.expert_ff()
    assert tuple(moe_t["wi"].shape) == (L, E, d, ff)
    assert tuple(moe_t["wo"].shape) == (L, E, ff, d)
    for name in ("wi", "wg", "wo"):  # (L, E, in, out), not transposed
        np.testing.assert_array_equal(moe_t[name].numpy(),
                                      np.asarray(moe_j[name]))
    assert moe_t["router"]["w"].dtype == torch.float32
    init = init_policy(cfg.replace(param_dtype="bfloat16"),
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    router = init["trunk"]["layers"]["moe"]["router"]["w"]
    assert router.dtype == torch.float32  # the router stays fp32
    assert init["trunk"]["layers"]["moe"]["wi"].dtype == torch.bfloat16
    wi = init["trunk"]["layers"]["moe"]["wi"].float()
    assert abs(float(wi.std()) * np.sqrt(d) - 1.0) < 0.05
    assert jax.tree_util.tree_map(
        lambda t: tuple(t.shape),
        init_policy(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")) == jax.tree_util.tree_map(
        lambda a: a.shape, pj)


def test_shared_mlp_of_the_reference_equals_the_port_one():
    cfg_j, cfg = _moe_cfgs(shared=2)
    pj, pt = _params(cfg_j)
    x = np.random.default_rng(8).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    assert tuple(pt["shared"]["wi"]["w"].shape) == (cfg.d_model, 2 * 64)
    _close(mlp_forward(pt["shared"], torch.from_numpy(x)),
           jmlp.mlp_forward(pj["shared"], jnp.asarray(x)), 1e-5)

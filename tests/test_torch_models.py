"""The port's qwen2 model against the JAX package's (CPU, reduced, fp32).

``qwen2-7b.reduced()`` is initialised in JAX and carried across with
``params_from_numpy``; the same numpy tokens go through both sides.
Prefill is held on logits, values and every layer's cache; then several
decode steps follow, with a scalar and with a per-row position. Tolerance
1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.models import policy_decode as jax_decode  # noqa: E402
from repro.models import policy_prefill as jax_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (init_policy, init_policy_cache,  # noqa: E402
                                policy_decode, policy_prefill)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.utils.bridge import params_from_numpy  # noqa: E402

TOL = 1e-4
S, ML = 11, 16


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def pair():
    cfg_j = jax_config("qwen2-7b").reduced()
    cfg = get_config("qwen2-7b").reduced()
    pj = jax_init(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return cfg_j, cfg, pj, pt


def _prefill_both(pair, tokens):
    cfg_j, cfg, pj, pt = pair
    lj, vj, cj = jax_prefill(pj, cfg_j, jnp.asarray(tokens), max_len=ML)
    lt, vt, ct = policy_prefill(pt, cfg, torch.from_numpy(tokens), max_len=ML)
    return (lj, vj, cj), (lt, vt, ct)


def test_prefill_matches_jax_on_logits_values_and_every_layer_cache(pair):
    cfg = pair[1]
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, S))
    (lj, vj, cj), (lt, vt, ct) = _prefill_both(pair, tokens)
    assert lt.shape == (2, S, cfg.vocab_size) and lt.dtype == torch.float32
    assert vt.shape == (2, S) and vt.dtype == torch.float32
    _close(lt, lj)
    _close(vt, vj)
    for name in ("k", "v"):
        ref = np.asarray(cj["layers"]["attn"][name])
        got = ct["layers"]["attn"][name]
        assert tuple(got.shape) == ref.shape == (
            cfg.num_layers, 2, ML, cfg.num_kv_heads, cfg.head_dim)
        for layer in range(cfg.num_layers):
            _close(got[layer], ref[layer])
        assert not got[:, :, S:].any()  # decode headroom stays zero


@pytest.mark.parametrize("mode", ["scalar", "per_row"])
def test_decode_steps_match_jax(pair, mode):
    cfg_j, cfg, pj, pt = pair
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (3, S))
    (_, _, cj), (_, _, ct) = _prefill_both(pair, tokens)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        if mode == "scalar":
            pos_j = pos_t = S + step
        else:  # rows at their own positions, as the serving engine runs them
            pos = np.array([S + step, S - 3 + step, S + 1 + step], np.int32)
            pos_j, pos_t = jnp.asarray(pos), torch.from_numpy(pos)
        lj, vj, cj = jax_decode(pj, cfg_j, cj, jnp.asarray(tok), pos_j)
        lt, vt, ct = policy_decode(pt, cfg, ct, torch.from_numpy(tok).long(),
                                   pos_t)
        assert lt.shape == (3, cfg.vocab_size) and vt.shape == (3,)
        _close(lt, lj)
        _close(vt, vj)
    for name in ("k", "v"):
        _close(ct["layers"]["attn"][name], cj["layers"]["attn"][name])


def test_common_blocks_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(tcommon.rmsnorm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x)),
           jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           1e-5)
    for pos in (np.arange(5), np.array([[3, 4, 5, 6, 7], [0, 9, 2, 30, 4]])):
        _close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                  10_000.0),
               jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
               1e-5)


def test_bridge_keeps_bfloat16_bits_and_layout():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 24).reshape(2, 3, 4),
                               jnp.bfloat16))
    t = params_from_numpy({"w": a, "nest": {"b": np.arange(3)}})
    assert t["w"].dtype == torch.bfloat16 and tuple(t["w"].shape) == (2, 3, 4)
    np.testing.assert_array_equal(t["w"].float().numpy(), a.astype(np.float32))
    assert t["nest"]["b"].tolist() == [0, 1, 2]


def test_port_init_matches_the_reference_tree_and_distributions(pair):
    cfg_j, cfg, pj, _ = pair
    pt = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    ref = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), pj)
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), pt)
    assert got == ref
    wq = pt["trunk"]["layers"]["attn"]["wq"]["w"]
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert abs(float(pt["trunk"]["embed"].std()) - 0.02) < 0.002
    assert not pt["trunk"]["layers"]["attn"]["wq"]["b"].any()


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(pair):
    cfg = pair[1]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_policy(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_policy_cache(cfg, 2, 8)
    with pytest.raises(ValueError, match="generator"):
        init_policy(cfg, generator=torch.Generator(), device="meta")


@pytest.mark.parametrize("change", ["sliding_window", "moe", "mla"])
def test_unported_features_raise_and_name_the_roadmap(pair, change):
    cfg = pair[1]
    kw = {"sliding_window": {"sliding_window": 64},
          "moe": {"family": "moe", "num_experts": 4},
          "mla": {"attention": "mla"}}[change]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_policy(cfg.replace(**kw), generator=torch.Generator(),
                    device="cpu")
    if change == "sliding_window":
        x = torch.zeros(1, 1, cfg.d_model)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tattn.gqa_decode({}, cfg, x, {"k": None, "v": None}, 0, window=8)

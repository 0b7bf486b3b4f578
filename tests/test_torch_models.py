"""The port's qwen2 model against the JAX package's (CPU, reduced, fp32).

``qwen2-7b.reduced()`` is initialised in JAX and carried across with
``params_from_numpy``; the same numpy tokens go through both sides.
Prefill is held on logits, values and every layer's cache; then several
decode steps follow, with a scalar and with a per-row position. Tolerance
1e-4. The full-sequence pass (``policy_apply``) of qwen2-7b, pixtral-12b
and seamless-m4t-large-v2 is held the same way.
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
from repro.models import policy_apply as jax_apply  # noqa: E402
from repro.models import policy_decode as jax_decode  # noqa: E402
from repro.models import policy_prefill as jax_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (init_policy, init_policy_cache,  # noqa: E402
                                policy_apply, policy_decode, policy_prefill)
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.utils.bridge import params_from_numpy  # noqa: E402

TOL = 1e-4
S, ML = 11, 16


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _pair(arch, **change):
    cfg_j = jax_config(arch).reduced().replace(**change)
    cfg = get_config(arch).reduced().replace(**change)
    pj = jax_init(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return cfg_j, cfg, pj, pt


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
    t = params_from_numpy({"w": a, "nest": {"b": np.arange(3)}}, "cpu")
    assert t["w"].dtype == torch.bfloat16 and tuple(t["w"].shape) == (2, 3, 4)
    np.testing.assert_array_equal(t["w"].float().numpy(), a.astype(np.float32))
    assert t["nest"]["b"].tolist() == [0, 1, 2]


def test_bridge_puts_params_on_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(3, np.float32)})


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


@pytest.mark.parametrize("arch", ["qwen2-7b", "pixtral-12b",
                                  "seamless-m4t-large-v2"])
def test_token_policy_apply_still_raises_and_names_the_roadmap(arch):
    """Once a refusal (ROADMAP Queue 1 item 11), now the training pass:
    ``policy_apply`` of a dense, a vision (8 patch embeddings before the
    text) and an encoder-decoder (16 frames) trunk against the
    reference's, logits and values within 1e-4."""
    cfg_j, cfg, pj, pt = _pair(arch)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    pre = None
    if cfg.modality == "vision":
        pre = rng.standard_normal((2, cfg.prefix_len, cfg.frontend_dim),
                                  dtype=np.float32)
    if cfg.is_encoder_decoder:
        pre = rng.standard_normal((2, cfg.encoder_seq_len, cfg.frontend_dim),
                                  dtype=np.float32)
    lj, vj, _ = jax_apply(pj, cfg_j, jnp.asarray(tokens),
                          None if pre is None else jnp.asarray(pre))
    lt, vt, aux = policy_apply(pt, cfg, torch.from_numpy(tokens),
                               None if pre is None else torch.from_numpy(pre))
    assert set(aux) == {"moe_aux"} and float(aux["moe_aux"]) == 0.0
    _close(lt.detach(), lj)
    _close(vt.detach(), vj)


def _cache_leaves(cache):
    return {(stack, name): leaf for stack, c in cache.items()
            for name, leaf in c["attn"].items()}


def _check_trunk_against_jax(pair, rng):
    """Prefill of S tokens (logits, values, every cache leaf), then four
    decode steps with a scalar and with a per-row position."""
    cfg_j, cfg, pj, pt = pair
    tokens = rng.integers(0, cfg.vocab_size, (3, S))
    lj, vj, cj = jax_prefill(pj, cfg_j, jnp.asarray(tokens), max_len=ML)
    lt, vt, ct = policy_prefill(pt, cfg, torch.from_numpy(tokens), max_len=ML)
    assert lt.shape == (3, S, cfg.vocab_size) and vt.shape == (3, S)
    _close(lt, lj, TOL)
    _close(vt, vj, TOL)
    got, ref = _cache_leaves(ct), _cache_leaves(cj)
    assert got.keys() == ref.keys()
    for key, leaf in got.items():
        assert tuple(leaf.shape) == np.asarray(ref[key]).shape
        _close(leaf, ref[key], TOL)
        assert not leaf[:, :, S:].any()
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        if step % 2:
            pos = np.array([S + step, S - 3 + step, S + 1 + step], np.int32)
            pos_j, pos_t = jnp.asarray(pos), torch.from_numpy(pos)
        else:
            pos_j = pos_t = S + step
        lj, vj, cj = jax_decode(pj, cfg_j, cj, jnp.asarray(tok), pos_j)
        lt, vt, ct = policy_decode(pt, cfg, ct, torch.from_numpy(tok).long(),
                                   pos_t)
        _close(lt, lj, TOL)
        _close(vt, vj, TOL)
    got, ref = _cache_leaves(ct), _cache_leaves(cj)
    for key, leaf in got.items():
        _close(leaf, ref[key], TOL)


@pytest.mark.parametrize("arch,change", [
    ("glm4-9b", {}),
    ("deepseek-coder-33b", {}),
    ("dbrx-132b", {"moe_capacity_factor": 1.25}),
    ("dbrx-132b", {"moe_capacity_factor": 16.0}),
    ("deepseek-v2-236b", {"mla_absorb": True, "moe_capacity_factor": 1.25}),
    ("deepseek-v2-236b", {"mla_absorb": True, "moe_capacity_factor": 16.0}),
    ("deepseek-v2-236b", {"mla_absorb": False, "moe_capacity_factor": 1.25}),
    ("deepseek-v2-236b", {"mla_absorb": False, "moe_capacity_factor": 16.0}),
], ids=["glm4", "deepseek-coder", "dbrx-cf1.25", "dbrx-cf16",
        "deepseek-absorbed-cf1.25", "deepseek-absorbed-cf16",
        "deepseek-naive-cf1.25", "deepseek-naive-cf16"])
def test_reduced_trunk_matches_jax(arch, change):
    pair = _pair(arch, **change)
    _check_trunk_against_jax(pair, np.random.default_rng(7))


def _stack_of_blocks(generator, cfg):
    """The build ``init_model`` replaced: every layer's block drawn into a
    list, then each leaf ``torch.stack``ed (twice the layers' bytes)."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    dtype = tcommon.dtype_of(cfg.param_dtype)
    p = {"embed": tcommon.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                     dtype)}
    block = (ttfm.init_ssm_block if cfg.family == "ssm"
             else ttfm.init_attn_block)
    p["layers"] = stack([block(generator, cfg, dtype)
                         for _ in range(cfg.num_layers)])
    p["final_norm"] = tcommon.init_rmsnorm(cfg.d_model, dtype,
                                           generator.device)
    return p


@pytest.mark.parametrize("arch", ["qwen2-7b", "minicpm3-4b", "mamba2-370m"])
def test_init_model_is_bitwise_the_stack_of_blocks_build(arch):
    cfg = get_config(arch).reduced().replace(num_layers=3)
    got = ttfm.init_model(torch.Generator().manual_seed(5), cfg)
    want = _stack_of_blocks(torch.Generator().manual_seed(5), cfg)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == b.dtype and torch.equal(a, b), path

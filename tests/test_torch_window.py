"""The port's sliding window against the JAX package's (CPU, fp32).

A window keeps a ring cache of ``min(max_len, sliding_window)`` slots
(token t at slot t % slots) and decodes over the slots younger than
``min(window, pos + 1)``; a ``window`` narrower than the cache, per call,
does the same on a full-length cache. Both sides get the same parameters,
drawn by the reference from ``PRNGKey(0)`` and carried across with
``params_from_numpy``, and the same numpy inputs.

* **The plain versions** of K4 and K5 with a window against a numpy
  reading of the age rule, for scalar and per-row positions.
* **Modules** — ``gqa_decode`` and ``mla_decode`` (absorbed and naive) with
  a window, on a ring and on a full cache, scalar and per-row, against the
  reference's: outputs and caches within 1e-4.
* **The dense trunk** — the port of ``test_sliding_window_ring_decode``
  (qwen2-7b, window 8, 24 tokens, an 8-slot cache) against the reference's
  windowed ``policy_apply``; a prefill into a ring (the cache equal to the
  reference's ``_cache_from_kv`` layout) then decoding on; a per-call
  ``window=4`` on a full cache through ``decode_step``.
* **The other trunks** — minicpm3-4b (MLA, absorbed and naive),
  deepseek-v2-236b (MoE with MLA) and zamba2-7b (the hybrid's shared
  block, window 16): prefill then decode against the reference. Logits
  within 5e-4 (``tests/test_decode_consistency.py``'s bound), prefill
  logits and caches within 1e-4.
* **Serving** — the engine's ``_place`` copies a ring-shaped prefill cache
  into its row alone, and continuous batching on rings (wrapped in the
  prefill and in the decode, per-row positions) equals a solo rerun,
  bitwise, torch against torch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.models import init_policy_cache as jax_cache  # noqa: E402
from repro.models import policy_apply as jax_apply  # noqa: E402
from repro.models import policy_decode as jax_decode  # noqa: E402
from repro.models import policy_prefill as jax_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import (init_policy_cache, policy_decode,  # noqa: E402
                                policy_prefill)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.utils.bridge import params_from_numpy  # noqa: E402

MODULE_TOL = 1e-4
PREFILL_TOL = 1e-4
DECODE_TOL = 5e-4  # tests/test_decode_consistency.py
B = 2


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _bridge(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _pair(arch, **change):
    """(reference config, port config, reference params, port params)."""
    cfg_j = jax_config(arch).reduced().replace(**change)
    cfg = get_config(arch).reduced().replace(**change)
    pj = jax_init(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg, pj, _bridge(pj)


def _age_live(pos: int, S: int, window: int) -> np.ndarray:
    """The reference's ring rule, read straight: slot j is live iff its age
    (pos mod S - j) mod S < min(window, pos + 1); window 0 is slots <= pos."""
    j = np.arange(S)
    if window == 0:
        return j <= pos
    return ((pos % S - j) % S) < min(window, pos + 1)


# ---------------------------------------------------------------- plain versions
LIVE_CASES = [  # (S, window, positions)
    (16, 0, [0, 5, 15, 16, 40]),
    (16, 1, [0, 3, 16, 33]),
    (16, 5, [0, 3, 4, 5, 15, 16, 19, 100]),
    (16, 16, [0, 15, 16, 47]),
    (16, 40, [3, 20, 63]),
    (7, 3, [-1, 0, 2, 6, 7, 13]),
]


@pytest.mark.parametrize("S,window,positions", LIVE_CASES)
def test_live_slots_follow_the_age_rule(S, window, positions):
    for p in positions:
        want = _age_live(p, S, window) if p >= 0 else np.zeros(S, bool)
        got = ref.live_slots(p, S, window, "cpu")
        assert got.shape == (1, S)
        np.testing.assert_array_equal(got[0].numpy(), want, err_msg=f"{p}")
    got = ref.live_slots(torch.tensor(positions, dtype=torch.int32), S,
                         window, "cpu")
    want = np.stack([_age_live(p, S, window) if p >= 0 else np.zeros(S, bool)
                     for p in positions])
    np.testing.assert_array_equal(got.numpy(), want)


def _softmax_rows(s, live):
    s = np.where(live, s, -np.inf)
    e = np.exp(s - s.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("S,window,positions", LIVE_CASES[1:5])
def test_decode_attention_ref_with_a_window(S, window, positions):
    """K4's plain version against numpy over the live slots alone, G = 2."""
    rng = np.random.default_rng(S + window)
    W, H, Hkv, D = len(positions), 4, 2, 8
    q = rng.standard_normal((W, H, D)).astype(np.float32)
    k = rng.standard_normal((W, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((W, S, Hkv, D)).astype(np.float32)
    pos = torch.tensor(positions, dtype=torch.int32)
    got = ref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), pos, window=window)
    for b, p in enumerate(positions):
        live = _age_live(p, S, window)
        kk = np.repeat(k[b], H // Hkv, axis=1)  # (S, H, D)
        vv = np.repeat(v[b], H // Hkv, axis=1)
        s = np.einsum("hd,khd->hk", q[b], kk) / np.sqrt(D)
        want = np.einsum("hk,khd->hd", _softmax_rows(s, live[None]), vv)
        _close(got[b], want, 1e-5)
        one = ref.decode_attention_ref(
            torch.from_numpy(q[b:b + 1]), torch.from_numpy(k[b:b + 1]),
            torch.from_numpy(v[b:b + 1]), p, window=window)
        torch.testing.assert_close(one[0], got[b], rtol=0, atol=0)


@pytest.mark.parametrize("S,window,positions", LIVE_CASES[1:5])
def test_mla_decode_attention_ref_with_a_window(S, window, positions):
    rng = np.random.default_rng(S * window)
    W, H, R, Rr = len(positions), 3, 16, 8
    ql = rng.standard_normal((W, H, R)).astype(np.float32)
    qr = rng.standard_normal((W, H, Rr)).astype(np.float32)
    c = rng.standard_normal((W, S, R)).astype(np.float32)
    kr = rng.standard_normal((W, S, Rr)).astype(np.float32)
    pos = torch.tensor(positions, dtype=torch.int32)
    got = ref.mla_decode_attention_ref(
        *map(torch.from_numpy, (ql, qr, c, kr)), pos, 0.3, window)
    for b, p in enumerate(positions):
        s = (ql[b] @ c[b].T + qr[b] @ kr[b].T) * 0.3
        want = _softmax_rows(s, _age_live(p, S, window)[None]) @ c[b]
        _close(got[b], want, 1e-5)


# ---------------------------------------------------------------- modules
def _module_steps(kind):
    """Positions of five decode steps: a scalar run that wraps an 8-slot
    ring, or per-row positions, one row ahead of the other."""
    if kind == "scalar":
        return [5, 6, 7, 8, 13]
    return [np.array([5 + t, 11 + 3 * t], np.int32) for t in range(5)]


def _jpos(pos):
    return jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos


def _tpos(pos):
    return torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos


@pytest.mark.parametrize("kind", ["scalar", "per_row"])
@pytest.mark.parametrize("setting", ["ring", "full_window"])
def test_gqa_decode_with_a_window_matches_the_reference(setting, kind):
    """A ring of 8 slots (``sliding_window`` 8), or a 24-slot cache decoded
    with ``window=4`` per call: the same random cache and five steps on
    both sides."""
    change = {"sliding_window": 8} if setting == "ring" else {}
    window = 0 if setting == "ring" else 4
    cfg_j = jax_config("qwen2-7b").reduced().replace(**change)
    cfg = get_config("qwen2-7b").reduced().replace(**change)
    pa_j = jattn.init_gqa(jax.random.PRNGKey(1), cfg_j, jnp.float32)
    pa_t = _bridge(pa_j)
    rng = np.random.default_rng(7)
    cj = jattn.init_gqa_cache(cfg_j, B, 24, jnp.float32)
    ct = tattn.init_gqa_cache(cfg, B, 24, torch.float32, "cpu")
    assert ct["k"].shape[1] == (8 if setting == "ring" else 24)
    fill = {k: rng.standard_normal(ct[k].shape).astype(np.float32)
            for k in ct}
    cj = {k: jnp.asarray(v) for k, v in fill.items()}
    ct = {k: torch.from_numpy(v.copy()) for k, v in fill.items()}
    for pos in _module_steps(kind):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        yj, cj = jattn.gqa_decode(pa_j, cfg_j, jnp.asarray(x), cj, _jpos(pos),
                                  window=window)
        yt, ct2 = tattn.gqa_decode(pa_t, cfg, torch.from_numpy(x), ct,
                                   _tpos(pos), window=window)
        assert ct2 is ct
        _close(yt, yj, MODULE_TOL)
    for k in ("k", "v"):
        _close(ct[k], cj[k], MODULE_TOL)


@pytest.mark.parametrize("kind", ["scalar", "per_row"])
@pytest.mark.parametrize("absorb", [True, False], ids=["absorb", "naive"])
@pytest.mark.parametrize("setting", ["ring", "full_window"])
def test_mla_decode_with_a_window_matches_the_reference(setting, absorb,
                                                        kind):
    change = {"mla_absorb": absorb}
    if setting == "ring":
        change["sliding_window"] = 8
    window = 0 if setting == "ring" else 4
    cfg_j = jax_config("minicpm3-4b").reduced().replace(**change)
    cfg = get_config("minicpm3-4b").reduced().replace(**change)
    pa_j = jattn.init_mla(jax.random.PRNGKey(2), cfg_j, jnp.float32)
    pa_t = _bridge(pa_j)
    rng = np.random.default_rng(11)
    ct = tattn.init_mla_cache(cfg, B, 24, torch.float32, "cpu")
    assert ct["c"].shape[1] == (8 if setting == "ring" else 24)
    fill = {k: rng.standard_normal(ct[k].shape).astype(np.float32)
            for k in ct}
    cj = {k: jnp.asarray(v) for k, v in fill.items()}
    ct = {k: torch.from_numpy(v.copy()) for k, v in fill.items()}
    for pos in _module_steps(kind):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        yj, cj = jattn.mla_decode(pa_j, cfg_j, jnp.asarray(x), cj, _jpos(pos),
                                  window=window)
        yt, _ = tattn.mla_decode(pa_t, cfg, torch.from_numpy(x), ct,
                                 _tpos(pos), window=window)
        _close(yt, yj, MODULE_TOL)
    for k in ("c", "kr"):
        _close(ct[k], cj[k], MODULE_TOL)


@pytest.mark.parametrize("window", [0, 5, 100])
def test_prefill_attention_takes_the_window(window):
    """``gqa_prefill`` with a window against the reference's: outputs and
    the cache contents (roped K, V) within 1e-4."""
    cfg_j = jax_config("qwen2-7b").reduced()
    cfg = get_config("qwen2-7b").reduced()
    pa_j = jattn.init_gqa(jax.random.PRNGKey(3), cfg_j, jnp.float32)
    x = np.random.default_rng(4).standard_normal(
        (B, 19, cfg.d_model)).astype(np.float32)
    yj, (kj, vj) = jattn.gqa_prefill(pa_j, cfg_j, jnp.asarray(x),
                                     window=window)
    yt, (kt, vt) = tattn.gqa_prefill(_bridge(pa_j), cfg, torch.from_numpy(x),
                                     window=window)
    _close(yt, yj, MODULE_TOL)
    _close(kt, kj, MODULE_TOL)
    _close(vt, vj, MODULE_TOL)


# ---------------------------------------------------------------- dense trunk
@pytest.fixture(scope="module")
def qwen_w8():
    return _pair("qwen2-7b", sliding_window=8)


def test_sliding_window_ring_decode(qwen_w8):
    """``tests/test_decode_consistency.py::test_sliding_window_ring_decode``
    on the port: a decode loop over 24 tokens on an 8-slot ring against the
    reference's windowed full pass."""
    cfg_j, cfg, pj, pt = qwen_w8
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, 24))
    logits_full, _, _ = jax_apply(pj, cfg_j, jnp.asarray(toks))
    cache = init_policy_cache(cfg, B, 24, device="cpu")
    assert cache["layers"]["attn"]["k"].shape[2] == 8  # O(window) memory
    err = 0.0
    for t in range(24):
        lg, _, cache = policy_decode(pt, cfg, cache,
                                     torch.from_numpy(toks[:, t:t + 1]), t)
        err = max(err, float(np.abs(lg.numpy()
                                    - np.asarray(logits_full[:, t])).max()))
    assert err < DECODE_TOL, err


def _cache_leaves(cache):
    return {tuple(getattr(k, "key", k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(cache)}


def _port_leaves(cache):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out[path] = t.numpy()

    walk(cache, ())
    return out


def _prefill_then_decode(pair, toks, half, max_len, *, window=None,
                         prefill_window=None, pre=None, off=0, steps=None):
    """Prefill ``toks[:, :half]`` on both sides (caches compared leaf by
    leaf), then decode the remaining tokens at ``off + t`` on both sides.
    Returns the largest logit gap of the decode steps."""
    cfg_j, cfg, pj, pt = pair
    pw = window if prefill_window is None else prefill_window
    lj, _, cj = jax_prefill(pj, cfg_j, jnp.asarray(toks[:, :half]), pre,
                            window=pw, max_len=max_len)
    lt, _, ct = policy_prefill(pt, cfg, torch.from_numpy(toks[:, :half]),
                               None if pre is None else torch.from_numpy(
                                   np.asarray(pre)),
                               window=pw, max_len=max_len)
    _close(lt, lj, PREFILL_TOL)
    got, want = _port_leaves(ct), _cache_leaves(cj)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].shape == want[key].shape, key
        _close(got[key], want[key], PREFILL_TOL)
    step = jax.jit(lambda p, c, t, pos: jax_decode(p, cfg_j, c, t, pos,
                                                   window=window))
    err = 0.0
    for t in range(half, toks.shape[1] if steps is None else half + steps):
        tok = toks[:, t:t + 1]
        lgj, _, cj = step(pj, cj, jnp.asarray(tok), jnp.int32(off + t))
        lgt, _, ct = policy_decode(pt, cfg, ct, torch.from_numpy(tok),
                                   off + t, window=window)
        err = max(err, float(np.abs(lgt.numpy() - np.asarray(lgj)).max()))
    return err


@pytest.mark.parametrize("S", [20, 8, 5], ids=["wrapped", "full", "short"])
def test_prefill_into_a_ring_matches_cache_from_kv(qwen_w8, S):
    """A prefill of S tokens into an 8-slot ring: S = 20 keeps the last 8
    tokens rolled by 20 % 8 (token t at slot t % 8), S = 8 fills it, S = 5
    leaves zero headroom; every leaf equals the reference's
    ``_cache_from_kv`` placement, and decoding goes on past 24 tokens."""
    toks = np.random.default_rng(S).integers(0, qwen_w8[1].vocab_size,
                                             (B, S + 6))
    err = _prefill_then_decode(qwen_w8, toks, S, 24)
    assert err < DECODE_TOL, err


def test_per_call_window_on_a_full_cache(qwen_w8):
    """No ``sliding_window`` in the config: ``window=4`` per call, in the
    prefill and each ``decode_step``, on a 30-slot cache (K4's age mask
    inside the model)."""
    cfg_j, cfg, pj, pt = qwen_w8
    pair = (cfg_j.replace(sliding_window=0), cfg.replace(sliding_window=0),
            pj, pt)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 18))
    cache = init_policy_cache(pair[1], B, 30, device="cpu")
    assert cache["layers"]["attn"]["k"].shape[2] == 30
    err = _prefill_then_decode(pair, toks, 10, 30, window=4)
    assert err < DECODE_TOL, err


def test_per_row_positions_on_a_ring(qwen_w8):
    """The serving engine's per-row positions on a ring: each row decodes
    the same tokens at its own offset, against the reference's per-row
    decode from the same zero cache."""
    cfg_j, cfg, pj, pt = qwen_w8
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, 14))
    offsets = np.array([0, 5], np.int32)
    cj = jax_cache(cfg_j, B, 24)
    ct = init_policy_cache(cfg, B, 24, device="cpu")
    step = jax.jit(lambda p, c, t, pos: jax_decode(p, cfg_j, c, t, pos))
    err = 0.0
    for t in range(14):
        pos = offsets + t
        tok = toks[:, t:t + 1]
        lgj, _, cj = step(pj, cj, jnp.asarray(tok), jnp.asarray(pos))
        lgt, _, ct = policy_decode(pt, cfg, ct, torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        err = max(err, float(np.abs(lgt.numpy() - np.asarray(lgj)).max()))
    assert err < DECODE_TOL, err
    _close(ct["layers"]["attn"]["k"], cj["layers"]["attn"]["k"], PREFILL_TOL)


# ---------------------------------------------------------------- other trunks
TRUNKS = {
    "minicpm3-4b-absorb": ("minicpm3-4b", {"sliding_window": 8,
                                           "mla_absorb": True}),
    "minicpm3-4b-naive": ("minicpm3-4b", {"sliding_window": 8,
                                          "mla_absorb": False}),
    # ample capacity: no token drops on either side
    "deepseek-v2-236b": ("deepseek-v2-236b", {"sliding_window": 8,
                                              "mla_absorb": True,
                                              "moe_capacity_factor": 16.0}),
}


@pytest.mark.parametrize("name", list(TRUNKS))
def test_trunk_with_a_window_matches_the_reference(name):
    """Prefill of 13 tokens into an 8-slot ring (the caches leaf by leaf),
    then 7 decode steps, against the reference."""
    arch, change = TRUNKS[name]
    pair = _pair(arch, **change)
    toks = np.random.default_rng(21).integers(0, pair[1].vocab_size, (B, 20))
    err = _prefill_then_decode(pair, toks, 13, 24)
    assert err < DECODE_TOL, err


def test_hybrid_shared_block_with_a_window():
    """zamba2-7b reduced with ``sliding_window`` 16: the shared block's
    ring (16 slots) after a 32-token prefill (one chunk), then 4
    decode steps, against the reference's decode loop over all the tokens
    from the zero cache (its hybrid prefill returns the zero cache); the
    prefill's logits against the reference's ``policy_prefill``."""
    cfg_j, cfg, pj, pt = _pair("zamba2-7b", sliding_window=16)
    S, ML = 32, 40
    toks = np.random.default_rng(31).integers(0, cfg.vocab_size, (B, S + 4))
    lj, _, _ = jax_prefill(pj, cfg_j, jnp.asarray(toks[:, :S]), max_len=ML)
    lt, _, ct = policy_prefill(pt, cfg, torch.from_numpy(toks[:, :S]),
                               max_len=ML)
    _close(lt, lj, PREFILL_TOL)
    assert ct["shared"]["attn"]["k"].shape[2] == 16
    step = jax.jit(lambda p, c, t, pos: jax_decode(p, cfg_j, c, t, pos))
    cj = jax_cache(cfg_j, B, ML)
    for t in range(S):
        _, _, cj = step(pj, cj, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
    _close(ct["shared"]["attn"]["k"], cj["shared"]["attn"]["k"], PREFILL_TOL)
    err = 0.0
    for t in range(S, S + 4):
        tok = toks[:, t:t + 1]
        lgj, _, cj = step(pj, cj, jnp.asarray(tok), jnp.int32(t))
        lgt, _, ct = policy_decode(pt, cfg, ct, torch.from_numpy(tok), t)
        err = max(err, float(np.abs(lgt.numpy() - np.asarray(lgj)).max()))
    assert err < DECODE_TOL, err


# ---------------------------------------------------------------- serving
def test_place_copies_a_ring_prefill_into_its_row(qwen_w8):
    """The engine's ``_place`` on ring-shaped leaves: a 20-token prefill
    into an 8-slot ring lands in row 1 of a 3-row cache, the other rows as
    they were."""
    from repro_torch.serving.engine import _place

    cfg, pt = qwen_w8[1], qwen_w8[3]
    big = init_policy_cache(cfg, 3, 24, device="cpu")
    g = torch.Generator().manual_seed(4)
    for leaf in big["layers"]["attn"].values():
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    before = {k: v.clone() for k, v in big["layers"]["attn"].items()}
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 20)))
    _, _, small = policy_prefill(pt, cfg, toks, max_len=24)
    _place(big, small, 1)
    for k, leaf in big["layers"]["attn"].items():
        assert leaf.shape[2] == 8
        torch.testing.assert_close(leaf[:, 1], small["layers"]["attn"][k][:, 0],
                                   rtol=0, atol=0)
        for row in (0, 2):
            torch.testing.assert_close(leaf[:, row], before[k][:, row],
                                       rtol=0, atol=0)


@pytest.mark.parametrize("arch,change", [
    ("qwen2-7b", {}), ("minicpm3-4b", {"mla_absorb": True})])
def test_bitwise_continuous_equals_solo_on_a_ring(arch, change):
    """Continuous batching on 8-slot rings (prompts up to 12 tokens, up to 8
    new ones: rings wrapped in the prefill and in the decode, rows at their
    own positions) gives each request the tokens it gets alone."""
    from repro_torch.models import init_policy
    from repro_torch.pipeline.queue import TrajectoryQueue
    from repro_torch.serving import (DecodeEngine, Request, Scheduler,
                                     make_requests)

    cfg = get_config(arch).reduced().replace(sliding_window=8, **change)
    params = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    W, L = 3, 24

    def feed(reqs):
        q = TrajectoryQueue(depth=len(reqs) + 2)
        for r in reqs:
            q.put(r)
        q.producer_done()
        return q

    reqs = make_requests(5, seed=11, prompt_lens=(4, 7, 12),
                         gen_range=(3, 8), vocab=cfg.vocab_size)
    by = {r.rid: r for r in Scheduler(
        DecodeEngine(cfg, params, max_slots=W, max_len=L, device="cpu"),
        feed(reqs), continuous=True).run()}
    assert all(r.status == "done" for r in by.values()) and len(by) == 5
    for probe in reqs:
        solo = Request(rid=probe.rid, prompt=probe.prompt.copy(),
                       max_new_tokens=probe.max_new_tokens, seed=probe.seed)
        Scheduler(DecodeEngine(cfg, params, max_slots=W, max_len=L,
                               device="cpu"), feed([solo]),
                  continuous=False).run()
        assert np.array_equal(by[probe.rid].tokens, solo.tokens), probe.rid

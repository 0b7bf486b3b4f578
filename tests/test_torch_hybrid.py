"""The port's hybrid trunk (zamba2-7b) against the JAX package's (CPU, fp32).

Reduced zamba2-7b at the reference's ``reduced()`` (one group of 2 Mamba2
layers, no tail) and at ``num_layers`` 5 (two groups of 2 and a tail of
1). Both sides get the same parameters, drawn by the reference's
``init_policy`` from ``PRNGKey(0)`` and carried across with
``params_from_numpy``, and the same numpy tokens.

* **Init** — the port's tree has the reference's keys, shapes and dtypes,
  and its stack-of-groups build is bitwise the build that draws every
  block into a list and stacks it.
* **Decode** — a decode loop from the zero cache, with a scalar and with a
  per-row position, against the reference's: logits and values within
  5e-4 (``tests/test_decode_consistency.py``'s bound).
* **Prefill** — logits and values against the reference's
  ``policy_prefill`` within 1e-4. The reference's hybrid prefill returns
  the zero cache; the port's fills it. So its cache is held against the
  reference's cache after decoding the same tokens from zero: every Mamba2
  state, conv tail and shared K/V leaf within 1e-4, K/V slots past the
  prompt zero; then 4 decode steps go on from both caches, logits within
  5e-4.
* **Experts** — with ``num_experts`` 4, top 2, in both forms of the
  shared block (``d_ff`` set: dense, the experts ignored; ``d_ff`` 0: the
  MoE block): ``policy_apply(train=True)`` with ``moe_aux`` 0, prefill,
  then 4 decode steps from the port's filled cache carried to the
  reference's decode, and one ``make_llm_train_step``.
* **Serving** — the engine's ``_place`` writes only the leased row, at
  every depth of the cache, at W = 1 and W = 3; continuous batching equals
  a solo rerun, bitwise, torch against torch; the launcher serves the
  reduced config on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.agents.paac import PAACAgent as JaxPAAC  # noqa: E402
from repro.core.agents.paac import PAACConfig as JaxPAACConfig  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.models import init_policy_cache as jax_cache  # noqa: E402
from repro.models import policy_apply as jax_apply  # noqa: E402
from repro.models import policy_decode as jax_decode  # noqa: E402
from repro.models import policy_prefill as jax_prefill  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.agents.paac import PAACAgent, PAACConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import (init_policy, init_policy_cache,  # noqa: E402
                                policy_apply, policy_decode, policy_prefill)
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving.engine import _place  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.utils.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402

PREFILL_TOL = 1e-4
DECODE_TOL = 5e-4  # tests/test_decode_consistency.py:60
B, S, ML = 2, 64, 72  # S: two chunks of the reduced config's 32
LAYERS = {"reduced": {}, "L5": {"num_layers": 5}}


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _leaves(cache):
    """{path: leaf} of a cache, paths as tuples of keys."""
    return {tuple(getattr(k, "key", k) for k in path): leaf for path, leaf
            in jax.tree_util.tree_leaves_with_path(cache)}


class _Case:
    """One reduced config on both sides, with the reference's decode loops
    run once and kept."""

    def __init__(self, change):
        self.cfg_j = jax_config("zamba2-7b").reduced().replace(**change)
        self.cfg = get_config("zamba2-7b").reduced().replace(**change)
        self.pj = jax_init(jax.random.PRNGKey(0), self.cfg_j)
        self.pt = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, self.pj), "cpu")
        self.tokens = np.random.default_rng(3).integers(
            0, self.cfg.vocab_size, (B, S))
        self.step = jax.jit(lambda p, c, t, pos: jax_decode(
            p, self.cfg_j, c, t, pos))
        self._loops = {}

    def ref_loop(self, offsets):
        """The reference's decode loop over ``tokens`` from the zero cache,
        row b at position t + offsets[b] (a scalar position when offsets is
        None): (logits (S, B, A), values (S, B), the final cache)."""
        key = None if offsets is None else tuple(offsets)
        if key not in self._loops:
            cache = jax_cache(self.cfg_j, B, ML)
            logits, values = [], []
            for t in range(S):
                pos = (jnp.int32(t) if offsets is None
                       else jnp.asarray(t + np.asarray(offsets), jnp.int32))
                lg, vl, cache = self.step(
                    self.pj, cache, jnp.asarray(self.tokens[:, t:t + 1]), pos)
                logits.append(np.asarray(lg))
                values.append(np.asarray(vl))
            self._loops[key] = (np.stack(logits), np.stack(values), cache)
        return self._loops[key]


@pytest.fixture(scope="module", params=list(LAYERS), ids=list(LAYERS))
def case(request):
    return _Case(LAYERS[request.param])


# ---------------------------------------------------------------- init
def test_init_tree_matches_the_reference(case):
    pt = init_policy(case.cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    ref = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), case.pj)
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), pt)
    assert got == ref
    every, n_groups, rem = ttfm._hybrid_dims(case.cfg)
    trunk = pt["trunk"]
    assert trunk["groups"]["mamba"]["w_x"]["w"].shape[:2] == (n_groups, every)
    assert ("tail" in trunk) == bool(rem)
    assert trunk["shared"]["mlp"]["wg"]["w"].shape == (
        case.cfg.d_model, case.cfg.d_ff)


def _list_build(generator, cfg):
    """The build ``init_model`` replaced: every block drawn into a list,
    then stacked group by group (twice the blocks' bytes)."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    dtype = tcommon.dtype_of(cfg.param_dtype)
    every, n_groups, rem = ttfm._hybrid_dims(cfg)
    p = {"embed": tcommon.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                     dtype)}
    blocks = [ttfm.init_ssm_block(generator, cfg, dtype)
              for _ in range(n_groups * every)]
    p["groups"] = stack([stack(blocks[g * every:(g + 1) * every])
                         for g in range(n_groups)])
    if rem:
        p["tail"] = stack([ttfm.init_ssm_block(generator, cfg, dtype)
                           for _ in range(rem)])
    p["shared"] = ttfm.init_attn_block(generator, cfg, dtype,
                                       dense_ff=cfg.d_ff)
    p["final_norm"] = tcommon.init_rmsnorm(cfg.d_model, dtype,
                                           generator.device)
    return p


@pytest.mark.parametrize("num_layers,every", [(2, 2), (5, 2), (7, 3)])
def test_init_model_is_bitwise_the_list_build(num_layers, every):
    cfg = get_config("zamba2-7b").reduced().replace(
        num_layers=num_layers, shared_attn_every=every)
    got = ttfm.init_model(torch.Generator().manual_seed(5), cfg)
    want = _list_build(torch.Generator().manual_seed(5), cfg)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == b.dtype and torch.equal(a, b), path
        assert a.is_contiguous(), path


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("offsets", [None, (0, 3)], ids=["scalar", "per_row"])
def test_decode_loop_from_the_zero_cache_matches_the_reference(case, offsets):
    ref_logits, ref_values, ref_cache = case.ref_loop(offsets)
    cache = init_policy_cache(case.cfg, B, ML, device="cpu")
    for t in range(S):
        pos = (t if offsets is None else
               torch.from_numpy((t + np.asarray(offsets)).astype(np.int32)))
        lg, vl, cache = policy_decode(
            case.pt, case.cfg, cache,
            torch.from_numpy(case.tokens[:, t:t + 1]), pos)
        assert lg.shape == (B, case.cfg.vocab_size) and vl.shape == (B,)
        _close(lg, ref_logits[t], DECODE_TOL)
        _close(vl, ref_values[t], DECODE_TOL)
    got, want = _leaves(cache), _leaves(ref_cache)
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        _close(leaf, want[path], DECODE_TOL)


# ---------------------------------------------------------------- prefill
def test_prefill_matches_the_reference_prefill(case):
    lj, vj, _ = jax_prefill(case.pj, case.cfg_j, jnp.asarray(case.tokens),
                            max_len=ML)
    lt, vt, _ = policy_prefill(case.pt, case.cfg,
                               torch.from_numpy(case.tokens), max_len=ML)
    assert lt.shape == (B, S, case.cfg.vocab_size)
    assert lt.dtype == vt.dtype == torch.float32
    _close(lt, lj, PREFILL_TOL)
    _close(vt, vj, PREFILL_TOL)


def test_prefill_fills_the_cache_the_reference_decode_loop_leaves(case):
    """F14: the port's prefill cache is the reference's after decoding the
    prompt from zero; decoding then goes on alike from both."""
    _, _, ref_cache = case.ref_loop(None)
    _, _, cache = policy_prefill(case.pt, case.cfg,
                                 torch.from_numpy(case.tokens), max_len=ML)
    got, want = _leaves(cache), _leaves(ref_cache)
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        ref = np.asarray(want[path])
        assert tuple(leaf.shape) == ref.shape, path
        assert str(leaf.dtype).endswith(str(ref.dtype)), path
        _close(leaf, ref, PREFILL_TOL)
        if path[0] == "shared":  # (n_groups, B, slots, Hkv, D)
            assert not leaf[:, :, S:].any(), path
    rng = np.random.default_rng(4)
    for step in range(4):
        tok = rng.integers(0, case.cfg.vocab_size, (B, 1))
        lj, vj, ref_cache = case.step(case.pj, ref_cache, jnp.asarray(tok),
                                      jnp.int32(S + step))
        lt, vt, cache = policy_decode(case.pt, case.cfg, cache,
                                      torch.from_numpy(tok), S + step)
        _close(lt, lj, DECODE_TOL)
        _close(vt, vj, DECODE_TOL)


def test_prefill_and_decode_go_through_k6_k3_and_k4(monkeypatch):
    """Once a Mamba2 layer through K6's dispatch and once a shared
    application through K3's in a prefill; K4's once an application in a
    decode step."""
    cfg = get_config("zamba2-7b").reduced().replace(num_layers=5)
    params = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    calls = []
    for name in ("ssd_scan", "flash_attention", "decode_attention"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    toks = torch.zeros((1, 64), dtype=torch.long)
    _, _, cache = policy_prefill(params, cfg, toks, max_len=72)
    assert calls == (["ssd_scan"] * 2 + ["flash_attention"]) * 2 + [
        "ssd_scan"]
    calls.clear()
    policy_decode(params, cfg, cache, toks[:, :1], 64)
    assert calls == ["decode_attention"] * 2


# the hybrid with experts in both forms of its shared block: d_ff set (a
# dense MLP, the experts ignored) and d_ff 0 (the MoE block, its experts
# 128 wide as the reduced MoE trunks' are: at moe_d_ff 0 they would take
# d_ff's width, 0)
EXPERTS = {"num_experts": 4, "num_experts_per_tok": 2}
MOE_FORMS = {"moe": EXPERTS, "moe_dff0": dict(EXPERTS, d_ff=0, moe_d_ff=128)}
_MOE_PAIRS = {}


def _moe_pair(form):
    """(jax cfg, torch cfg, jax params, torch params) of reduced zamba2-7b
    with experts, bridged from the reference's ``PRNGKey(0)`` draw."""
    if form not in _MOE_PAIRS:
        cfg_j = jax_config("zamba2-7b").reduced().replace(**MOE_FORMS[form])
        cfg = get_config("zamba2-7b").reduced().replace(**MOE_FORMS[form])
        pj = jax_init(jax.random.PRNGKey(0), cfg_j)
        pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
        _MOE_PAIRS[form] = (cfg_j, cfg, pj, pt)
    return _MOE_PAIRS[form]


@pytest.mark.parametrize("change", list(MOE_FORMS), ids=list(MOE_FORMS))
def test_unported_hybrid_settings_raise_and_name_the_roadmap(change):
    """The hybrid with experts, which the port once refused, against the
    reference: the shared block is the reference's (dense when d_ff is
    set, MoE when it is 0); ``policy_apply(train=True)`` within 1e-4 with
    ``moe_aux`` 0 on both sides (the group drops the block's aux loss);
    prefill within 1e-4; then 4 decode steps from the port's filled cache,
    carried across to the reference's decode, within 5e-4."""
    cfg_j, cfg, pj, pt = _moe_pair(change)
    shared = pt["trunk"]["shared"]
    assert ("moe" in shared) == (cfg.d_ff == 0)
    assert ("mlp" in shared) == bool(cfg.d_ff)
    if "moe" in shared:
        assert shared["moe"]["wi"].shape == (4, cfg.d_model, 128)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    lj, vj, aj = jax_apply(pj, cfg_j, jnp.asarray(tokens), train=True)
    lt, vt, at = policy_apply(pt, cfg, torch.from_numpy(tokens), train=True)
    _close(lt.detach(), lj, PREFILL_TOL)
    _close(vt.detach(), vj, PREFILL_TOL)
    assert float(at["moe_aux"]) == float(aj["moe_aux"]) == 0.0
    lj, vj, _ = jax_prefill(pj, cfg_j, jnp.asarray(tokens), max_len=ML)
    lt, vt, cache = policy_prefill(pt, cfg, torch.from_numpy(tokens),
                                   max_len=ML)
    _close(lt, lj, PREFILL_TOL)
    _close(vt, vj, PREFILL_TOL)
    # copies: the port's decode updates its cache in place
    ref_cache = jax.tree_util.tree_map(lambda t: jnp.array(t.numpy().copy()),
                                       cache)
    step = jax.jit(lambda p, c, t, pos: jax_decode(p, cfg_j, c, t, pos))
    rng = np.random.default_rng(4)
    for i in range(4):
        tok = rng.integers(0, cfg.vocab_size, (B, 1))
        lj, vj, ref_cache = step(pj, ref_cache, jnp.asarray(tok),
                                 jnp.int32(S + i))
        lt, vt, cache = policy_decode(pt, cfg, cache, torch.from_numpy(tok),
                                      S + i)
        _close(lt, lj, DECODE_TOL)
        _close(vt, vj, DECODE_TOL)


@pytest.mark.parametrize("form", list(MOE_FORMS))
def test_a_train_step_of_the_hybrid_with_experts_matches_the_reference(form):
    """One ``make_llm_train_step`` with RMSProp on both sides: the loss and
    each metric within 1e-5, every parameter after the update within 1e-5
    (``tests/test_torch_token_training.py``'s bounds), over T 16."""
    cfg_j, cfg, pj, pt = _moe_pair(form)
    rng = np.random.default_rng(0)
    T = 16
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T + 1)
                                    ).astype(np.int32),
             "rewards": rng.random((B, T), dtype=np.float32),
             "dones": rng.random((B, T)) < 0.2}
    jstep = jax.jit(JaxPAAC(cfg_j, JaxPAACConfig()).make_llm_train_step(
        jax_make_optimizer("rmsprop"), jax_constant(1e-3)))
    opt = make_optimizer("rmsprop")
    pj_new, _, mj = jstep(pj, jax_make_optimizer("rmsprop").init(pj),
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          jnp.int32(0))
    pt_new, _, mt = PAACAgent(cfg, PAACConfig()).make_llm_train_step(
        opt, constant(1e-3))(pt, opt.init(pt),
                             {k: torch.from_numpy(np.asarray(v))
                              for k, v in batch.items()}, 0)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(pt_new)),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(np.asarray, pj_new))):
        _close(a, b, 1e-5)


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("W", [1, 3])
def test_place_writes_only_the_leased_row_at_every_depth(W):
    cfg = get_config("zamba2-7b").reduced().replace(num_layers=5)
    params = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    g = torch.Generator().manual_seed(1)
    big = tree_map(lambda t: torch.randn(t.shape, generator=g).to(t.dtype),
                   init_policy_cache(cfg, W, ML, device="cpu"))
    before = tree_map(torch.clone, big)
    _, _, small = policy_prefill(params, cfg, torch.arange(20)[None],
                                 max_len=ML)
    slot = W - 1
    _place(big, small, slot)
    row_axis = {"groups": 2, "shared": 1, "tail": 1}
    for path, leaf in _leaves(big).items():
        one = _leaves(small)[path]
        axis = row_axis[path[0]]
        assert torch.equal(leaf.select(axis, slot), one.select(axis, 0)), path
        for other in range(W):
            if other != slot:
                assert torch.equal(leaf.select(axis, other),
                                   _leaves(before)[path].select(axis, other))


def test_bitwise_continuous_equals_solo_on_reduced_zamba2():
    from repro_torch.pipeline.queue import TrajectoryQueue
    from repro_torch.serving import (DONE, DecodeEngine, Request, Scheduler,
                                     make_requests)

    cfg = get_config("zamba2-7b").reduced().replace(num_layers=5)
    params = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    W, L = 3, 48

    def feed(reqs):
        q = TrajectoryQueue(depth=len(reqs) + 1)
        for r in reqs:
            q.put(r)
        q.producer_done()
        return q

    reqs = make_requests(5, seed=12, prompt_lens=(4, 32), gen_range=(3, 8),
                         vocab=cfg.vocab_size)
    sched = Scheduler(DecodeEngine(cfg, params, max_slots=W, max_len=L,
                                   device="cpu"), feed(reqs), continuous=True)
    by = {r.rid: r for r in sched.run()}
    assert all(r.status == DONE for r in by.values()) and len(by) == 5
    for probe in reqs:
        solo = Request(rid=probe.rid, prompt=probe.prompt.copy(),
                       max_new_tokens=probe.max_new_tokens, seed=probe.seed)
        Scheduler(DecodeEngine(cfg, params, max_slots=W, max_len=L,
                               device="cpu"), feed([solo]),
                  continuous=False).run()
        assert np.array_equal(by[probe.rid].tokens, solo.tokens), probe.rid


def test_launcher_serves_zamba2_on_the_cpu():
    from repro_torch.launch.serve import main

    res = main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                "--continuous", "--requests", "4", "--slots", "2",
                "--prompt-len", "64", "--gen", "4"])
    assert res["admitted"] == 4
    assert all(r.status == "done" for r in res["requests"])
    res = main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "32", "--gen", "3"])
    assert res["tokens"].shape == (2, 4) and res["logits_finite"]

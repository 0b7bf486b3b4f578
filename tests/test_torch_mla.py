"""The port's MLA path against the JAX package's (CPU, small shapes).

* **K5's plain version** (``ref.mla_decode_attention_ref``) against
  ``repro.kernels.ref`` and ``mla_decode_attention_pallas`` in interpret
  mode at ``tests/test_extensions.py``'s shapes (fp32 3e-5, bf16 3e-2),
  and its per-row ``pos`` row by row against the scalar reference.
* **K3's plain version with v narrower than q/k** against
  ``flash_attention_pallas`` (fp32 1e-5).
* **MLA modules** — ``mla_forward`` and ``mla_decode`` (naive and absorbed,
  scalar and per-row pos) on bridged weights of reduced minicpm3-4b, fp32,
  against ``repro.models.attention`` (1e-5).
* **The slice** — ``policy_prefill`` plus decode steps of reduced
  minicpm3-4b, absorbed and naive, against the JAX package's, logits within
  5e-4 (``tests/test_decode_consistency.py``'s bound), and every layer's
  cache; continuous batching equal to a solo rerun, bitwise, torch against
  torch; the serving launcher with ``--arch minicpm3-4b``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.mla_decode import mla_decode_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.models import policy_decode as jax_decode  # noqa: E402
from repro.models import policy_prefill as jax_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.mla_decode import (  # noqa: E402
    check_inputs as check_mla, mla_decode_attention_cuda)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import init_policy, policy_decode, policy_prefill  # noqa: E402
from repro_torch.utils.bridge import params_from_numpy  # noqa: E402

SLICE_TOL = 5e-4  # tests/test_decode_consistency.py:78
MODULE_TOL = 1e-5
S, ML = 11, 20


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------- K5 plain
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sk,H,R,Rr,pos", [
    (128, 8, 64, 16, 100),  # tests/test_extensions.py shapes
    (300, 16, 128, 32, 299),
    (512, 4, 32, 8, 0),
])
def test_plain_mla_decode_matches_reference_and_pallas(dtype, Sk, H, R, Rr,
                                                        pos):
    B = 2
    rng = np.random.default_rng(Sk + H)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    arrs = [np.asarray(jnp.asarray(rng.standard_normal(s), jdt))
            for s in ((B, H, R), (B, H, Rr), (B, Sk, R), (B, Sk, Rr))]
    scale = 1.0 / np.sqrt(R + Rr)
    out = tref.mla_decode_attention_ref(
        *[params_from_numpy(a, "cpu") for a in arrs], pos, scale)
    assert out.shape == (B, H, R) and out.dtype == getattr(torch, dtype)
    j = [jnp.asarray(a) for a in arrs]
    tol = 3e-2 if dtype == "bfloat16" else 3e-5
    _close(_np(out), jref.mla_decode_attention_ref(*j, pos, scale), tol)
    _close(_np(out), mla_decode_attention_pallas(*j, pos, scale, block_k=128),
           tol)


def test_plain_mla_decode_per_row_pos_matches_reference_row_by_row():
    """A (B,) pos is the port's extension (the TPU kernel takes a scalar):
    row b is held against the reference at the scalar pos[b]."""
    B, Sk, H, R, Rr = 3, 96, 4, 32, 16
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, R), (B, H, Rr), (B, Sk, R), (B, Sk, Rr))]
    pos = [95, 0, 40]
    out = tref.mla_decode_attention_ref(
        *[torch.from_numpy(a) for a in arrs],
        torch.tensor(pos, dtype=torch.int32), 0.2)
    for b, p in enumerate(pos):
        row = [jnp.asarray(a[b:b + 1]) for a in arrs]
        _close(_np(out[b:b + 1]), jref.mla_decode_attention_ref(*row, p, 0.2),
               3e-5)
        _close(_np(out[b:b + 1]),
               mla_decode_attention_pallas(*row, p, 0.2, block_k=32), 3e-5)


# ---------------------------------------------------------------- K3, Dv != D
@pytest.mark.parametrize("B,Sq,H,D,Dv", [
    (2, 64, 4, 48, 32),  # reduced minicpm3-4b: qk 32 + 16, v 32
    (1, 100, 8, 96, 64),  # minicpm3-4b: qk 64 + 32, v 64 (ragged S)
])
def test_plain_flash_with_narrow_v_matches_pallas(B, Sq, H, D, Dv):
    rng = np.random.default_rng(D)
    q, k = (rng.standard_normal((B, Sq, H, D)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, Sq, H, Dv)).astype(np.float32)
    out = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v))
    assert out.shape == (B, Sq, H, Dv)
    _close(out, flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), block_q=64,
                                       block_k=64), 1e-5)


# ---------------------------------------------------------------- modules
@pytest.fixture(scope="module")
def pair():
    cfg_j = jax_config("minicpm3-4b").reduced()
    cfg = get_config("minicpm3-4b").reduced()
    pj = jax_init(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return cfg_j, cfg, pj, pt


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def test_mla_forward_matches_jax_with_its_cache_contents(pair):
    cfg_j, cfg, pj, pt = pair
    x = np.random.default_rng(3).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    pa_j = _layer0(pj["trunk"]["layers"]["attn"])
    pa_t = _layer0(pt["trunk"]["layers"]["attn"])
    yj, (cj, krj) = jattn.mla_forward(pa_j, cfg_j, jnp.asarray(x),
                                      return_cache=True)
    yt, (ct, krt) = tattn.mla_forward(pa_t, cfg, torch.from_numpy(x))
    assert tuple(ct.shape) == (2, S, cfg.kv_lora_rank)
    assert tuple(krt.shape) == (2, S, cfg.qk_rope_dim)
    _close(yt, yj, MODULE_TOL)
    _close(ct, cj, MODULE_TOL)
    _close(krt, krj, MODULE_TOL)


@pytest.mark.parametrize("absorb", [True, False])
@pytest.mark.parametrize("mode", ["scalar", "per_row"])
def test_mla_decode_matches_jax(pair, absorb, mode):
    cfg_j, cfg, pj, pt = pair
    cfg_j, cfg = cfg_j.replace(mla_absorb=absorb), cfg.replace(mla_absorb=absorb)
    rng = np.random.default_rng(4)
    B = 3
    pa_j = _layer0(pj["trunk"]["layers"]["attn"])
    pa_t = _layer0(pt["trunk"]["layers"]["attn"])
    cache = {"c": rng.standard_normal((B, ML, cfg.kv_lora_rank)),
             "kr": rng.standard_normal((B, ML, cfg.qk_rope_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    cj = {k: jnp.asarray(v) for k, v in cache.items()}
    ct = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    for step in range(3):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        if mode == "scalar":
            pos_j = pos_t = S + step
        else:
            pos = np.array([S + step, 2 + step, ML - 3 + step], np.int32)
            pos_j, pos_t = jnp.asarray(pos), torch.from_numpy(pos)
        yj, cj = jattn.mla_decode(pa_j, cfg_j, jnp.asarray(x), cj, pos_j)
        yt, ct2 = tattn.mla_decode(pa_t, cfg, torch.from_numpy(x), ct, pos_t)
        assert ct2 is ct  # written in place
        _close(yt, yj, MODULE_TOL)
    for k in ("c", "kr"):
        _close(ct[k], cj[k], MODULE_TOL)


# ---------------------------------------------------------------- the slice
@pytest.mark.parametrize("absorb", [True, False])
def test_reduced_minicpm3_prefill_and_decode_match_jax(pair, absorb):
    cfg_j, cfg, pj, pt = pair
    cfg_j, cfg = cfg_j.replace(mla_absorb=absorb), cfg.replace(mla_absorb=absorb)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, S))
    lj, vj, cj = jax_prefill(pj, cfg_j, jnp.asarray(toks), max_len=ML)
    lt, vt, ct = policy_prefill(pt, cfg, torch.from_numpy(toks), max_len=ML)
    assert lt.shape == (2, S, cfg.vocab_size) and lt.dtype == torch.float32
    _close(lt, lj, SLICE_TOL)
    _close(vt, vj, SLICE_TOL)
    for name, width in (("c", cfg.kv_lora_rank), ("kr", cfg.qk_rope_dim)):
        got = ct["layers"]["attn"][name]
        assert tuple(got.shape) == (cfg.num_layers, 2, ML, width)
        _close(got, cj["layers"]["attn"][name], SLICE_TOL)
        assert not got[:, :, S:].any()  # decode headroom stays zero
    for step, pos in enumerate([S, np.array([S + 1, S - 4], np.int32), S + 2,
                                np.array([S + 3, S - 2], np.int32)]):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pj_, pt_ = ((jnp.asarray(pos), torch.from_numpy(pos))
                    if isinstance(pos, np.ndarray) else (pos, pos))
        lj, vj, cj = jax_decode(pj, cfg_j, cj, jnp.asarray(tok), pj_)
        lt, vt, ct = policy_decode(pt, cfg, ct, torch.from_numpy(tok).long(),
                                   pt_)
        _close(lt, lj, SLICE_TOL)
        _close(vt, vj, SLICE_TOL)


def test_absorbed_decode_goes_through_the_k5_dispatch(pair, monkeypatch):
    """On the absorbed path every layer's decode attention is one call of
    ``ops.mla_decode_attention`` (K5 on the card); the naive path never
    calls it."""
    cfg, pt = pair[1], pair[3]
    calls = []
    real = ops.mla_decode_attention

    def spy(*a, **k):
        calls.append(a[4])
        return real(*a, **k)

    monkeypatch.setattr(ops, "mla_decode_attention", spy)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, S)))
    for absorb, want in ((True, cfg.num_layers), (False, 0)):
        c = cfg.replace(mla_absorb=absorb)
        _, _, cache = policy_prefill(pt, c, toks, max_len=ML)
        calls.clear()
        policy_decode(pt, c, cache, toks[:, :1], S)
        assert len(calls) == want


def test_bitwise_continuous_equals_solo_on_reduced_minicpm3():
    from repro_torch.pipeline.queue import TrajectoryQueue
    from repro_torch.serving import (DONE, DecodeEngine, Request, Scheduler,
                                     make_requests)

    cfg = get_config("minicpm3-4b").reduced().replace(mla_absorb=True)
    params = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    W, L = 3, 24

    def feed(reqs):
        q = TrajectoryQueue(depth=len(reqs) + 1)
        for r in reqs:
            q.put(r)
        q.producer_done()
        return q

    reqs = make_requests(5, seed=11, prompt_lens=(4, 7, 9), gen_range=(3, 8),
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


def test_launcher_serves_minicpm3_on_the_cpu():
    from repro_torch.launch.serve import main

    res = main(["--arch", "minicpm3-4b", "--reduced", "--device", "cpu",
                "--continuous", "--requests", "4", "--slots", "2",
                "--prompt-len", "12", "--gen", "4"])
    assert res["admitted"] == 4
    assert all(r.status == "done" for r in res["requests"])
    res = main(["--arch", "minicpm3-4b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert res["tokens"].shape == (2, 4) and res["logits_finite"]


# ---------------------------------------------------------------- wrapper
def test_bridge_carries_the_mla_tree_unchanged(pair):
    cfg_j, _, pj, pt = pair
    ref = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), pj)
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), pt)
    assert got == ref
    a = pt["trunk"]["layers"]["attn"]
    assert tuple(a["wukv"]["w"].shape) == (
        cfg_j.num_layers, cfg_j.kv_lora_rank,
        cfg_j.num_heads * (cfg_j.qk_nope_dim + cfg_j.v_head_dim))
    init = init_policy(get_config("minicpm3-4b").reduced(),
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        init) == ref


def test_k5_wrapper_refuses_cpu_tensors_and_bad_inputs():
    ql, qr = torch.zeros(2, 4, 32), torch.zeros(2, 4, 16)
    c, kr = torch.zeros(2, 8, 32), torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        mla_decode_attention_cuda(ql, qr, c, kr, 3, 0.1)
    check_mla(ql, qr, c, kr, torch.zeros(2, dtype=torch.int32))  # accepted
    bad = {
        "latent width": (torch.zeros(2, 4, 48), qr, torch.zeros(2, 8, 48), kr, 3),
        "rope width": (ql, torch.zeros(2, 4, 8), c, torch.zeros(2, 8, 8), 3),
        "mismatch": (ql, qr, torch.zeros(2, 8, 64), kr, 3),
        "dtype": (ql.bfloat16(), qr, c, kr, 3),
        "pos dtype": (ql, qr, c, kr, torch.zeros(2, dtype=torch.int64)),
        "pos shape": (ql, qr, c, kr, torch.zeros(3, dtype=torch.int32)),
        "pos float": (ql, qr, c, kr, 3.0),
        "strided": (torch.zeros(4, 2, 32).transpose(0, 1), qr, c, kr, 3),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            check_mla(*args)

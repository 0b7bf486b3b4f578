"""The port's Mamba2 path against the JAX package's (CPU, small shapes).

* **K6's plain version** (``ref.ssd_scan_ref``, ``ssd_chunked``'s algorithm)
  against ``repro.models.ssm.ssd_chunked``, ``repro.kernels.ref.ssd_scan_ref``
  (the exact sequential recurrence) and ``ssd_scan_pallas`` in interpret
  mode at ``tests/test_kernels.py``'s shapes and tolerances (rtol 1e-4,
  atol 2e-3 or 1e-4), y and final state, and against this file's own
  sequential-recurrence oracle; both routes refuse a sequence that is not
  a whole number of chunks.
* **Mamba2 modules** — ``mamba2_forward`` (with its final state and conv
  tails) and ``mamba2_decode`` on bridged weights of reduced mamba2-370m,
  fp32, against ``repro.models.ssm`` (1e-5).
* **The slice** — ``policy_prefill`` plus decode steps of reduced
  mamba2-370m against the JAX package's, logits within 5e-4
  (``tests/test_decode_consistency.py``'s bound), and every layer's cache;
  continuous batching equal to a solo rerun, bitwise, torch against torch;
  the serving launcher with ``--arch mamba2-370m``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.models import policy_decode as jax_decode  # noqa: E402
from repro.models import policy_prefill as jax_prefill  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ssd_scan import check_inputs as check_ssd  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_cuda  # noqa: E402
from repro_torch.models import init_policy, policy_decode, policy_prefill  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.utils.bridge import params_from_numpy  # noqa: E402

SCAN_TOL = 1e-4  # tests/test_kernels.py:131-133
SLICE_TOL = 5e-4  # tests/test_decode_consistency.py:78
MODULE_TOL = 1e-5


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _scan_inputs(rng, B, S, H, P, N):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A_log = np.log(np.arange(1, H + 1, dtype=np.float32))
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    D = np.ones(H, np.float32)
    return x, dt, A_log, Bm, Cm, D


def _sequential(x, dt, A_log, Bm, Cm, D):
    """The SSD recurrence one step at a time, in torch: the oracle that
    ``repro/kernels/ref.py::ssd_scan_ref`` is in JAX."""
    x, dt, Bm, Cm = (torch.from_numpy(a).double() for a in (x, dt, Bm, Cm))
    lam = torch.exp(-torch.exp(torch.from_numpy(A_log).double()) * dt)
    B, S, H, P = x.shape
    state = torch.zeros(B, H, P, Bm.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(S):
        state = state * lam[:, t, :, None, None] + (
            dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t]))
    y = torch.stack(ys, 1) + torch.from_numpy(D).double()[None, None, :, None] * x
    return y.numpy(), state.numpy()


# ---------------------------------------------------------------- K6 plain
@pytest.mark.parametrize("S,H,P,N,chunk,atol", [
    (64, 2, 16, 8, 16, 2e-3),  # tests/test_kernels.py::test_ssd_scan
    (256, 4, 32, 16, 64, 2e-3),
    (128, 8, 64, 64, 128, 2e-3),  # single chunk
    (128, 4, 32, 16, 32, 1e-4),  # test_ssd_scan_matches_model_chunked
])
def test_plain_ssd_scan_matches_chunked_reference_and_pallas(S, H, P, N,
                                                              chunk, atol):
    """At the reference test's own tolerance for the shape: rtol 1e-4, atol
    ``atol`` (C.B^T sums of up to 128 terms of ~N(0, N) cancel, and the
    frameworks sum in other orders)."""
    inputs = _scan_inputs(np.random.default_rng(S + N), 2, S, H, P, N)
    y, state = tref.ssd_scan_ref(*[torch.from_numpy(a) for a in inputs],
                                 chunk=chunk)
    assert y.shape == (2, S, H, P) and state.shape == (2, H, P, N)
    assert state.dtype == torch.float32
    j = [jnp.asarray(a) for a in inputs]
    for want_y, want_s in (jssm.ssd_chunked(*j, chunk=chunk),
                           jref.ssd_scan_ref(*j), _sequential(*inputs)):
        np.testing.assert_allclose(y, want_y, rtol=SCAN_TOL, atol=atol)
        np.testing.assert_allclose(state, want_s, rtol=SCAN_TOL, atol=atol)
    np.testing.assert_allclose(y, ssd_scan_pallas(*j, chunk=chunk),
                               rtol=SCAN_TOL, atol=atol)


def test_plain_ssd_scan_keeps_x_dtype_and_refuses_a_ragged_chunk():
    inputs = [torch.from_numpy(a) for a in
              _scan_inputs(np.random.default_rng(0), 1, 64, 2, 16, 8)]
    x16 = inputs[0].bfloat16()
    y, state = ops.ssd_scan(x16, inputs[1], inputs[2], inputs[3].bfloat16(),
                            inputs[4].bfloat16(), inputs[5], chunk=32)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(*inputs, chunk=48)


# ---------------------------------------------------------------- modules
@pytest.fixture(scope="module")
def pair():
    cfg_j = jax_config("mamba2-370m").reduced()
    cfg = get_config("mamba2-370m").reduced()
    pj = jax_init(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return cfg_j, cfg, pj, pt


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("S", [64, 32, 2])
def test_mamba2_forward_matches_jax_with_state_and_tails(pair, S):
    """S = 2 is shorter than the conv window: the tails are zero-padded on
    the left, as the conv sees them (the reference would slice only 2 of
    the 3 steps and could not stack them into its cache)."""
    cfg_j, cfg, pj, pt = pair
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    pm_j = _layer0(pj["trunk"]["layers"]["mamba"])
    pm_t = _layer0(pt["trunk"]["layers"]["mamba"])
    yj, (sj, tj) = jssm.mamba2_forward(pm_j, cfg_j, jnp.asarray(x),
                                       return_state=True)
    yt, (st, tt) = tssm.mamba2_forward(pm_t, cfg, torch.from_numpy(x),
                                       return_state=True)
    _close(yt, yj, MODULE_TOL)
    _close(st, sj, MODULE_TOL)
    K = cfg.ssm_conv
    for a, b in zip(tt, tj):
        assert a.shape[1] == K - 1
        _close(a[:, K - 1 - b.shape[1]:], b, MODULE_TOL)
        assert not a[:, :K - 1 - b.shape[1]].any()


def test_mamba2_decode_matches_jax_and_updates_the_cache_in_place(pair):
    cfg_j, cfg, pj, pt = pair
    rng = np.random.default_rng(8)
    B = 3
    pm_j = _layer0(pj["trunk"]["layers"]["mamba"])
    pm_t = _layer0(pt["trunk"]["layers"]["mamba"])
    cj = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.standard_normal(a.shape), a.dtype),
        jssm.init_mamba2_cache(cfg_j, B, jnp.float32))
    ct = {k: torch.from_numpy(v.copy()) for k, v in cj.items()}
    cj = {k: jnp.asarray(v) for k, v in cj.items()}
    for _ in range(3):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        yj, cj = jssm.mamba2_decode(pm_j, cfg_j, jnp.asarray(x), cj)
        yt, ct2 = tssm.mamba2_decode(pm_t, cfg, torch.from_numpy(x), ct)
        assert ct2 is ct
        _close(yt, yj, MODULE_TOL)
    for k in ct:
        _close(ct[k], cj[k], MODULE_TOL)


# ---------------------------------------------------------------- the slice
@pytest.mark.parametrize("S", [64, 20])
def test_reduced_mamba2_prefill_and_decode_match_jax(pair, S):
    """S = 64 is two chunks of 32; S = 20 is one chunk of 20."""
    cfg_j, cfg, pj, pt = pair
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (2, S))
    lj, vj, cj = jax_prefill(pj, cfg_j, jnp.asarray(toks), max_len=S + 8)
    lt, vt, ct = policy_prefill(pt, cfg, torch.from_numpy(toks),
                                max_len=S + 8)
    assert lt.shape == (2, S, cfg.vocab_size) and lt.dtype == torch.float32
    _close(lt, lj, SLICE_TOL)
    _close(vt, vj, SLICE_TOL)
    for k, want in cj["layers"].items():
        got = ct["layers"][k]
        assert tuple(got.shape) == want.shape and str(got.dtype).endswith(
            str(want.dtype))
        _close(got, want, SLICE_TOL)
    for pos in (S, np.array([S + 1, S - 5], np.int32), S + 2):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pj_, pt_ = ((jnp.asarray(pos), torch.from_numpy(pos))
                    if isinstance(pos, np.ndarray) else (pos, pos))
        lj, vj, cj = jax_decode(pj, cfg_j, cj, jnp.asarray(tok), pj_)
        lt, vt, ct = policy_decode(pt, cfg, ct, torch.from_numpy(tok).long(),
                                   pt_)
        _close(lt, lj, SLICE_TOL)
        _close(vt, vj, SLICE_TOL)


def test_prefill_goes_through_the_k6_dispatch_once_a_layer(pair, monkeypatch):
    cfg, pt = pair[1], pair[3]
    calls = []
    real = ops.ssd_scan

    def spy(*a, **k):
        calls.append(k["chunk"])
        return real(*a, **k)

    monkeypatch.setattr(ops, "ssd_scan", spy)
    toks = torch.zeros((1, 64), dtype=torch.long)
    policy_prefill(pt, cfg, toks, max_len=72)
    assert calls == [cfg.ssm_chunk] * cfg.num_layers
    with pytest.raises(ValueError, match="chunk"):
        policy_prefill(pt, cfg, toks[:, :40], max_len=72)


def test_bitwise_continuous_equals_solo_on_reduced_mamba2():
    from repro_torch.pipeline.queue import TrajectoryQueue
    from repro_torch.serving import (DONE, DecodeEngine, Request, Scheduler,
                                     make_requests)

    cfg = get_config("mamba2-370m").reduced()
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


def test_launcher_serves_mamba2_on_the_cpu():
    from repro_torch.launch.serve import main

    res = main(["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
                "--continuous", "--requests", "4", "--slots", "2",
                "--prompt-len", "64", "--gen", "4"])
    assert res["admitted"] == 4
    assert all(r.status == "done" for r in res["requests"])
    res = main(["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "32", "--gen", "3"])
    assert res["tokens"].shape == (2, 4) and res["logits_finite"]


# ---------------------------------------------------------------- bridge, K6
def test_bridge_carries_the_mamba2_tree_unchanged_in_bfloat16():
    """Depthwise conv weights (K, C) are not under ``convs`` and cross as
    they are; the fp32 leaves of a bf16 model stay fp32."""
    cfg_j = jax_config("mamba2-370m").reduced().replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    pj = jax_init(jax.random.PRNGKey(1), cfg_j)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    ref = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), pj)
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), pt)
    assert got == ref
    m = pt["trunk"]["layers"]["mamba"]
    assert tuple(m["conv_x"].shape) == (cfg_j.num_layers, cfg_j.ssm_conv,
                                        cfg_j.ssm_expand * cfg_j.d_model)
    for k in ("dt_bias", "A_log", "D"):
        assert m[k].dtype == torch.float32
    np.testing.assert_array_equal(
        m["conv_B"].float().numpy(),
        np.asarray(pj["trunk"]["layers"]["mamba"]["conv_B"], np.float32))
    init = init_policy(get_config("mamba2-370m").reduced().replace(
        param_dtype="bfloat16", compute_dtype="bfloat16"),
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        init) == ref


def test_k6_wrapper_refuses_cpu_tensors_and_bad_inputs():
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in _scan_inputs(
        np.random.default_rng(1), 1, 64, 2, 64, 16))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=32)
    check_ssd(x, dt, A, Bm, Cm, D, chunk=32)  # accepted
    bad = {
        "ragged chunk": ((x, dt, A, Bm, Cm, D), 48),
        "chunk too long": ((x, dt, A, Bm, Cm, D), 256),
        "head width": ((x[..., :32].contiguous(), dt, A, Bm, Cm, D), 32),
        "state width": ((x, dt, A, Bm[..., :8].contiguous(),
                         Cm[..., :8].contiguous(), D), 32),
        "dt dtype": ((x, dt.bfloat16(), A, Bm, Cm, D), 32),
        "B dtype": ((x, dt, A, Bm.bfloat16(), Cm, D), 32),
        "shape": ((x, dt[:, :32].contiguous(), A, Bm, Cm, D), 32),
        "strided": ((x, dt, A, Bm.transpose(1, 2).contiguous().transpose(
            1, 2), Cm, D), 32),
    }
    for name, (args, chunk) in bad.items():
        with pytest.raises(ValueError):
            check_ssd(*args, chunk=chunk)

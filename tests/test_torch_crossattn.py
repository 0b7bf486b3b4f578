"""The port's cross-attention, encoder-decoder and vision trunks against the
JAX package's (CPU, fp32).

seamless-m4t-large-v2 (audio encoder-decoder) and pixtral-12b (a decoder
after a prefix of patch embeddings) at the reference's ``reduced()``. Both
sides get the same parameters, drawn by the reference from ``PRNGKey(0)``
and carried across with ``params_from_numpy``, and the same numpy tokens
and front-end embeddings.

* **Modules** — the reference's ``gqa_forward`` with ``kv_src``
  (non-causal, no rope) against ``cross_forward`` over ``project_kv``'s
  K/V, as causal self-attention (windowed too) against ``gqa_prefill``,
  and the one-token ``cross_decode`` against the reference's
  ``_cross_decode``, within 1e-4.
* **The encoder** — its output against the reference's ``_run_encoder``
  within 1e-4. The reference's encoder is causal, though its docstring
  says "bidirectional" (F17): the port mirrors it, and a changed last
  frame must leave every earlier output as it was, on both sides.
* **The caches** — every leaf of the port's prefill cache, ``"cross"``
  included, against the reference's ``policy_prefill`` within 1e-4.
* **Prefill, then decode** — the port of
  ``tests/test_decode_consistency.py::test_prefill_resume``: a prefill of
  half the tokens then decode steps, against the reference's
  ``policy_apply`` logits within 5e-4.
* **Serving** — the engine still refuses both, as the reference's does.
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
from repro.models import policy_apply as jax_apply  # noqa: E402
from repro.models import policy_prefill as jax_prefill  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import (init_policy, init_policy_cache,  # noqa: E402
                                policy_decode, policy_prefill)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.serving.engine import DecodeEngine  # noqa: E402
from repro_torch.utils.bridge import params_from_numpy  # noqa: E402

MODULE_TOL = 1e-4
PREFILL_TOL = 1e-4
DECODE_TOL = 5e-4  # tests/test_decode_consistency.py
B, S = 2, 16
ARCHS = ["seamless-m4t-large-v2", "pixtral-12b"]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _bridge(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


class _Case:
    """One reduced config on both sides, with its tokens and front-end
    embeddings (frames for the encoder, patches for the prefix)."""

    def __init__(self, arch):
        self.cfg_j = jax_config(arch).reduced()
        self.cfg = get_config(arch).reduced()
        self.pj = jax_init(jax.random.PRNGKey(0), self.cfg_j)
        self.pt = _bridge(self.pj)
        rng = np.random.default_rng(5)
        self.tokens = rng.integers(0, self.cfg.vocab_size, (B, S))
        n = (self.cfg.encoder_seq_len if self.cfg.is_encoder_decoder
             else self.cfg.prefix_len)
        self.pre = rng.standard_normal(
            (B, n, self.cfg.frontend_dim)).astype(np.float32)
        # the prefix's positions before the text (0 for the encoder-decoder)
        self.off = self.cfg.prefix_len if self.cfg.family == "vlm" else 0


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return _Case(request.param)


@pytest.fixture(scope="module")
def seamless():
    return _Case("seamless-m4t-large-v2")


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_references(arch):
    assert arch in list_archs()
    assert get_config(arch) == get_config(arch)  # a fresh copy each time
    mine, theirs = get_config(arch), jax_config(arch)
    for field in type(mine).__dataclass_fields__:
        assert getattr(mine, field) == getattr(theirs, field), field


def test_init_tree_matches_the_reference(case):
    pt = init_policy(case.cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    ref = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), case.pj)
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), pt)
    assert got == ref
    trunk = pt["trunk"]
    assert "frontend_proj" in trunk
    assert ("encoder" in trunk) == case.cfg.is_encoder_decoder
    assert ("xattn" in trunk["layers"]) == case.cfg.is_encoder_decoder


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("mode", ["cross", "self_causal", "self_window"])
def test_gqa_forward_matches_the_reference(seamless, mode):
    cfg_j, cfg = seamless.cfg_j, seamless.cfg
    pa_j = jattn.init_gqa(jax.random.PRNGKey(4), cfg_j, jnp.float32,
                          cross=True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 11, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    pa = _bridge(pa_j)
    if mode == "cross":
        want = jattn.gqa_forward(pa_j, cfg_j, jnp.asarray(x),
                                 kv_src=jnp.asarray(src), causal=False,
                                 use_rope=False)
        k, v = tattn.project_kv(pa, cfg, torch.from_numpy(src))
        got = tattn.cross_forward(pa, cfg, torch.from_numpy(x), k, v)
    else:
        window = 3 if mode == "self_window" else 0
        want = jattn.gqa_forward(pa_j, cfg_j, jnp.asarray(x), window=window)
        got, _ = tattn.gqa_prefill(pa, cfg, torch.from_numpy(x), window=window)
    assert got.shape == (B, 11, cfg.d_model)
    _close(got, want, MODULE_TOL)


def test_cross_decode_matches_the_reference(seamless):
    cfg_j, cfg = seamless.cfg_j, seamless.cfg
    pa_j = jattn.init_gqa(jax.random.PRNGKey(8), cfg_j, jnp.float32,
                          cross=True)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, 16, cfg.num_kv_heads, cfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    want = jtfm._cross_decode(pa_j, cfg_j, jnp.asarray(x), jnp.asarray(ck),
                              jnp.asarray(cv))
    got = tattn.cross_decode(_bridge(pa_j), cfg, torch.from_numpy(x),
                             torch.from_numpy(ck), torch.from_numpy(cv))
    _close(got, want, MODULE_TOL)


# ---------------------------------------------------------------- encoder
def _encoders(case, frames):
    """(port, reference) encoder outputs of frames (B, n, frontend_dim)."""
    tp, jp = case.pt["trunk"], case.pj["trunk"]
    got = ttfm._run_encoder(tp, case.cfg, ttfm._front(
        tp, case.cfg, torch.from_numpy(frames)))
    pre = jtfm.linear(jp["frontend_proj"], jnp.asarray(frames))
    want = jtfm._run_encoder(jp, case.cfg_j, pre, False)
    return got, want


def test_encoder_matches_the_reference_and_is_causal(seamless):
    """F17: the reference's encoder is causal (``_run_encoder``'s
    ``causal=False`` never reaches ``gqa_prefill``), and so is the port's:
    each output agrees within 1e-4, and changing the last frame leaves every
    earlier position's output as it was on both sides. A bidirectional
    encoder would fail both checks."""
    frames = seamless.pre
    got, want = _encoders(seamless, frames)
    assert got.shape == (B, seamless.cfg.encoder_seq_len, seamless.cfg.d_model)
    _close(got, want, MODULE_TOL)
    moved = frames.copy()
    moved[:, -1] += 1.0
    got2, want2 = _encoders(seamless, moved)
    torch.testing.assert_close(got2[:, :-1], got[:, :-1], rtol=0, atol=1e-6)
    _close(want2[:, :-1], want[:, :-1], 1e-6)
    assert float((got2[:, -1] - got[:, -1]).abs().max()) > 1e-3


def test_encoder_decoder_needs_frames(seamless):
    with pytest.raises(ValueError, match="prefix_embeds"):
        policy_prefill(seamless.pt, seamless.cfg,
                       torch.from_numpy(seamless.tokens))


# ---------------------------------------------------------------- caches
def _leaves(cache):
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


def test_prefill_cache_matches_the_reference(case):
    """Logits, values and every cache leaf (the self-attention K/V with
    decode headroom, and for the encoder-decoder ``"cross"``) after a
    prefill of the whole prompt."""
    half = S // 2
    ml = case.off + S
    lj, vj, cj = jax_prefill(case.pj, case.cfg_j,
                             jnp.asarray(case.tokens[:, :half]),
                             jnp.asarray(case.pre), max_len=ml)
    lt, vt, ct = policy_prefill(case.pt, case.cfg,
                                torch.from_numpy(case.tokens[:, :half]),
                                torch.from_numpy(case.pre), max_len=ml)
    assert lt.shape == (B, case.off + half, case.cfg.vocab_size)
    _close(lt, lj, PREFILL_TOL)
    _close(vt, vj, PREFILL_TOL)
    got, want = _port_leaves(ct), _leaves(cj)
    assert got.keys() == want.keys()
    assert (("cross", "k") in got) == case.cfg.is_encoder_decoder
    for key in got:
        assert got[key].shape == want[key].shape, key
        _close(got[key], want[key], PREFILL_TOL)
    fresh = init_policy_cache(case.cfg, B, ml, device="cpu")
    assert {k: tuple(v.shape) for k, v in _port_leaves(fresh).items()} == {
        k: v.shape for k, v in got.items()}


def test_prefill_resume(case):
    """``tests/test_decode_consistency.py::test_prefill_resume`` on the
    port: prefill of half the tokens (after the patch prefix, or with the
    encoder's frames), then decode steps at ``off + t`` with scalar
    positions, against the reference's full ``policy_apply``."""
    logits_full, _, _ = jax_apply(case.pj, case.cfg_j,
                                  jnp.asarray(case.tokens),
                                  jnp.asarray(case.pre))
    full = np.asarray(logits_full)
    off, half = case.off, S // 2
    lg_p, _, cache = policy_prefill(case.pt, case.cfg,
                                    torch.from_numpy(case.tokens[:, :half]),
                                    torch.from_numpy(case.pre),
                                    max_len=off + S)
    err = float(np.abs(lg_p[:, -1].numpy() - full[:, off + half - 1]).max())
    for t in range(half, S):
        lg, _, cache = policy_decode(
            case.pt, case.cfg, cache,
            torch.from_numpy(case.tokens[:, t:t + 1]), off + t)
        err = max(err, float(np.abs(lg.numpy() - full[:, off + t]).max()))
    assert err < DECODE_TOL, err


def test_decode_with_per_row_positions(case):
    """The decode step with a (B,) position tensor equal to the scalar one
    gives the scalar path's logits bitwise, row by row."""
    half = S // 2
    toks = torch.from_numpy(case.tokens)
    pre = torch.from_numpy(case.pre)
    outs = []
    for per_row in (False, True):
        _, _, cache = policy_prefill(case.pt, case.cfg, toks[:, :half], pre,
                                     max_len=case.off + S)
        for t in range(half, half + 3):
            p = case.off + t
            pos = torch.full((B,), p, dtype=torch.int32) if per_row else p
            lg, _, cache = policy_decode(case.pt, case.cfg, cache,
                                         toks[:, t:t + 1], pos)
        outs.append(lg)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_kernels_of_the_path(seamless, monkeypatch):
    """The encoder-decoder's dispatch: K3 once an encoder layer, twice a
    decoder layer (self and cross) in a prefill; K4 twice a decoder layer
    in a decode step (self and cross)."""
    calls = []
    for name in ("flash_attention", "decode_attention"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    cfg = seamless.cfg
    toks = torch.from_numpy(seamless.tokens)
    _, _, cache = policy_prefill(seamless.pt, cfg, toks[:, :4],
                                 torch.from_numpy(seamless.pre), max_len=8)
    L, E = cfg.num_layers, cfg.encoder_layers
    assert calls == ["flash_attention"] * (E + 2 * L)
    calls.clear()
    policy_decode(seamless.pt, cfg, cache, toks[:, 4:5], 4)
    assert calls == ["decode_attention"] * (2 * L)


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS)
def test_the_engine_still_refuses_them(arch):
    """As the reference's engine does (``repro/serving/engine.py:56-59``):
    no admission path carries frames or patches."""
    cfg = get_config(arch).reduced()
    params = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(ValueError, match="text token models only"):
        DecodeEngine(cfg, params, max_slots=2, max_len=32, device="cpu")

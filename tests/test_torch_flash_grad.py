"""K3's log-sum-exp and its gradient against the JAX package's (CPU, fp32).

* **The LSE** of ``ref.flash_attention_ref(..., return_lse=True)``, which
  the CPU forward of ``ops.FlashAttention`` returns, against the reference's
  ``_flash_fwd`` (``repro/models/attention.py:59-96``) on the same pre-scaled,
  padded inputs ``chunked_attention`` gives it: within 1e-5 (absolute and
  relative), and the output within 1e-5 too.
* **The backward** (``ref.flash_attention_bwd`` through
  ``ops.flash_attention`` with inputs that need a gradient) against
  ``jax.vjp`` of ``repro.models.attention.chunked_attention`` with the same
  cotangent: dq, dk and dv within 1e-5 (absolute and relative; both sum
  the same fp32 products block by block, in another order inside each
  product) for GQA causal, windowed, MLA's widths (q/k wider than v),
  non-causal with Sq < Sk and Sq > Sk (the cross-attention), and keys past
  one 512-key block.
* Without a gradient, ``ops.flash_attention`` stays the serving path: the
  plain version's output, bitwise, and no ``FlashAttention`` node.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 1e-5

# (B, Sq, Sk, H, Hkv, D, Dv, causal, window)
CASES = {
    "gqa-causal": (2, 40, 40, 4, 2, 32, 32, True, 0),
    "windowed": (2, 40, 40, 4, 2, 32, 32, True, 7),
    "mla-48-32": (2, 24, 24, 4, 4, 48, 32, True, 0),
    "mla-96-64": (1, 20, 20, 2, 2, 96, 64, True, 5),
    "cross-sq-lt-sk": (2, 12, 40, 4, 2, 32, 32, False, 0),
    "cross-sq-gt-sk": (2, 40, 12, 4, 1, 32, 32, False, 0),
    "two-blocks": (1, 600, 600, 2, 1, 16, 16, True, 0),
}


def _inputs(case, seed=0):
    B, Sq, Sk, H, Hkv, D, Dv, causal, window = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, Sk, Hkv, Dv), dtype=np.float32)
    g = rng.standard_normal((B, Sq, H, Dv), dtype=np.float32)
    return (q, k, v, g), dict(causal=causal, window=window)


def _jax_fwd(q, k, v, causal, window, block_k=512):
    """``_flash_fwd`` on the inputs ``chunked_attention`` prepares."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    block_k = min(block_k, Sk)
    pad = (-Sk) % block_k
    k = jnp.pad(jnp.asarray(k), ((0, 0), (0, pad), (0, 0), (0, 0)))
    v = jnp.pad(jnp.asarray(v), ((0, 0), (0, pad), (0, 0), (0, 0)))
    nb = (Sk + pad) // block_k
    qg = (jnp.asarray(q) * scale).reshape(B, Sq, Hkv, G, D)
    kb = k.reshape(B, nb, block_k, Hkv, D).transpose(1, 0, 2, 3, 4)
    vb = v.reshape(B, nb, block_k, Hkv, Dv).transpose(1, 0, 2, 3, 4)
    out, lse = jattn._flash_fwd(qg, kb, vb, causal, window, 0, block_k, scale,
                                Sk)
    return (np.asarray(out).reshape(B, Sq, H, Dv),
            np.asarray(lse).reshape(B, Sq, H))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_lse_matches_the_references_flash_fwd(case):
    (q, k, v, _), kw = _inputs(case)
    out, lse = tref.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        return_lse=True, **kw)
    want_out, want_lse = _jax_fwd(q, k, v, kw["causal"], kw["window"])
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    _close(lse, want_lse)
    _close(out, want_out)


def test_a_row_that_sees_no_key_gets_the_clamped_lse():
    """Sq > Sk with a window: rows past Sk + window - 1 see no key; their
    LSE is m = -1e30, as the reference's clamp leaves it."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 12, 2, 32), dtype=np.float32)
    k = rng.standard_normal((1, 4, 1, 32), dtype=np.float32)
    v = rng.standard_normal((1, 4, 1, 32), dtype=np.float32)
    _, lse = tref.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=2, return_lse=True)
    _, want = _jax_fwd(q, k, v, True, 2)
    assert (lse[0, 6:] == tref.NEG_INF).all()
    np.testing.assert_array_equal(lse[0, 6:].numpy(), want[0, 6:])
    _close(lse[0, :5], want[0, :5])


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_jax_vjp_of_chunked_attention(case):
    (q, k, v, g), kw = _inputs(case)

    def f(q_, k_, v_):
        return jattn.chunked_attention(q_, k_, v_, **kw)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = ops.launches["flash_attention"]
    out = ops.flash_attention(tq, tk, tv, **kw)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    out.backward(torch.from_numpy(g))
    assert ops.launches["flash_attention"] == before  # the CPU launches none
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.shape == w.shape
        _close(got, w)


@pytest.mark.parametrize("case", ["gqa-causal", "mla-48-32", "cross-sq-lt-sk"])
def test_backward_matches_autograd_through_the_plain_version(case):
    """The hand-derived backward equals torch's autograd through the
    materialised softmax of ``flash_attention_ref``."""
    (q, k, v, g), kw = _inputs(case, seed=3)
    a = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    ops.flash_attention(*a, **kw).backward(torch.from_numpy(g))
    tref.flash_attention_ref(*b, **kw).backward(torch.from_numpy(g))
    for x, y in zip(a, b):
        _close(x.grad, y.grad)


def test_without_a_gradient_the_serving_path_is_unchanged():
    (q, k, v, _), kw = _inputs("windowed")
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    assert out.grad_fn is None
    assert torch.equal(out, tref.flash_attention_ref(tq, tk, tv, **kw))
    with torch.no_grad():
        out = ops.flash_attention(tq.requires_grad_(True), tk, tv, **kw)
    assert out.grad_fn is None
    # with a gradient the forward's output is the same bits
    out_g = ops.flash_attention(tq, tk, tv, **kw)
    assert torch.equal(out_g.detach(), out)


def test_the_function_returns_grads_in_the_inputs_dtypes():
    (q, k, v, g), kw = _inputs("gqa-causal")
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
                  for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    for t in (tq, tk, tv):
        assert t.grad.dtype == torch.bfloat16
        assert torch.isfinite(t.grad.float()).all()

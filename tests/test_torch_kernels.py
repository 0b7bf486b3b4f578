"""The port's kernels against the reference's (CPU, small shapes).

The plain versions in ``repro_torch/kernels/ref.py`` are held against
``repro/kernels/ref.py`` and against the Pallas kernels run in interpret
mode, on the same numpy inputs, fp32, tolerance 1e-5. The dispatch tests
pin the no-fallback rule: CPU tensors go to the plain version, the CUDA
wrappers refuse CPU tensors, and ``resolve_device()`` raises without a
card. The hand-written kernels themselves run only on the card; their
tests are in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    check_inputs as check_decode, decode_attention_cuda)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check_inputs as check_flash, flash_attention_cuda)

TOL = 1e-5


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------- flash
FLASH_CASES = [  # (B, Sq, Sk, H, Hkv, D, causal, window)
    (2, 64, 64, 4, 4, 32, True, 0),    # tests/test_kernels.py shapes
    (2, 128, 128, 4, 2, 64, True, 0),
    (2, 100, 100, 8, 1, 64, True, 0),  # padded seq, MQA
    (2, 256, 256, 4, 4, 128, True, 0),
    (2, 64, 64, 4, 4, 32, True, 37),
    (2, 128, 128, 4, 2, 64, True, 37),
    (2, 100, 100, 8, 1, 64, True, 37),
    (2, 256, 256, 4, 4, 128, True, 37),
    (2, 96, 96, 4, 4, 32, False, 0),   # non-causal
    (1, 77, 77, 28, 4, 128, True, 0),  # ragged Sq, qwen2's G = 7
    (1, 150, 150, 14, 2, 64, True, 50),  # window, G = 7
]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", FLASH_CASES)
def test_plain_flash_matches_reference_and_pallas(B, Sq, Sk, H, Hkv, D,
                                                  causal, window):
    rng = np.random.default_rng(Sq * 31 + H)
    q, k, v = (_normal(rng, B, Sq, H, D), _normal(rng, B, Sk, Hkv, D),
               _normal(rng, B, Sk, Hkv, D))
    out = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   window=window)
    assert out.shape == (B, Sq, H, D) and out.dtype == torch.float32
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                         window=window))
    _close(out, flash_attention_pallas(jq, jk, jv, causal=causal,
                                       window=window, block_q=64,
                                       block_k=64))


# ---------------------------------------------------------------- decode
DECODE_CASES = [  # (B, S, H, Hkv, D, pos)
    (2, 128, 4, 4, 32, 80),  # tests/test_kernels.py shapes
    (2, 300, 8, 2, 64, 299),
    (2, 512, 8, 1, 128, 0),
    (3, 160, 28, 4, 128, 97),  # qwen2's G = 7
]


@pytest.mark.parametrize("B,S,H,Hkv,D,pos", DECODE_CASES)
def test_plain_decode_scalar_pos_matches_reference_and_pallas(B, S, H, Hkv,
                                                              D, pos):
    rng = np.random.default_rng(S + pos)
    q, kc, vc = (_normal(rng, B, H, D), _normal(rng, B, S, Hkv, D),
                 _normal(rng, B, S, Hkv, D))
    out = tref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(kc),
                                    torch.from_numpy(vc), pos)
    assert out.shape == (B, H, D)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc)
    _close(out, jref.decode_attention_ref(jq, jk, jv, pos))
    _close(out, decode_attention_pallas(jq, jk, jv, pos, block_k=128))


@pytest.mark.parametrize("B,S,H,Hkv,D,pos", [
    (4, 128, 4, 4, 32, [0, 5, 64, 127]),
    (3, 300, 28, 4, 128, [299, 0, 131]),
    (2, 200, 8, 2, 64, [63, 64]),
])
def test_plain_decode_per_row_pos_matches_reference_row_by_row(B, S, H, Hkv,
                                                               D, pos):
    """A (B,) pos is the port's extension: row b is held against the
    reference at the scalar pos[b]."""
    rng = np.random.default_rng(S * 7 + B)
    q, kc, vc = (_normal(rng, B, H, D), _normal(rng, B, S, Hkv, D),
                 _normal(rng, B, S, Hkv, D))
    out = tref.decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.tensor(pos, dtype=torch.int32))
    for b, p in enumerate(pos):
        row = (jnp.asarray(q[b:b + 1]), jnp.asarray(kc[b:b + 1]),
               jnp.asarray(vc[b:b + 1]))
        _close(out[b:b + 1], jref.decode_attention_ref(*row, p))
        _close(out[b:b + 1], decode_attention_pallas(*row, p, block_k=128))


# ---------------------------------------------------------------- dispatch
def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 33, 4, 32)),
               torch.from_numpy(_normal(rng, 1, 33, 2, 32)),
               torch.from_numpy(_normal(rng, 1, 33, 2, 32)))
    ops.reset_launches()
    _close(ops.flash_attention(q, k, v), tref.flash_attention_ref(q, k, v))
    qd = q[:, 0].contiguous()
    pos = torch.tensor([7], dtype=torch.int32)
    _close(ops.decode_attention(qd, k, v, pos),
           tref.decode_attention_ref(qd, k, v, pos))
    assert ops.launches == {"flash_attention": 0, "decode_attention": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        decode_attention_cuda(q[:, 0].contiguous(), k, k, 3)


@pytest.mark.parametrize("bad", ["float16", "shape", "strided", "head_dim",
                                 "groups", "window"])
def test_flash_wrapper_checks_its_inputs(bad):
    q, k, v = torch.zeros(1, 8, 4, 32), torch.zeros(1, 8, 2, 32), \
        torch.zeros(1, 8, 2, 32)
    window = 0
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "shape":
        k = torch.zeros(1, 8, 2, 64)
    elif bad == "strided":
        q = torch.zeros(1, 4, 8, 32).transpose(1, 2)
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48),
                   torch.zeros(1, 8, 2, 48))
    elif bad == "groups":
        k, v = torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32)
    elif bad == "window":
        window = -1
    with pytest.raises(ValueError):
        check_flash(q, k, v, window=window)


@pytest.mark.parametrize("bad", ["pos_dtype", "pos_shape", "pos_float",
                                 "pos_bool", "bfloat_mix", "too_many_heads"])
def test_decode_wrapper_checks_its_inputs(bad):
    q, kc = torch.zeros(2, 4, 32), torch.zeros(2, 16, 2, 32)
    vc = kc.clone()
    pos = torch.zeros(2, dtype=torch.int32)
    if bad == "pos_dtype":
        pos = pos.long()
    elif bad == "pos_shape":
        pos = torch.zeros(3, dtype=torch.int32)
    elif bad == "pos_float":
        pos = 3.0
    elif bad == "pos_bool":
        pos = True
    elif bad == "bfloat_mix":
        q = q.bfloat16()
    elif bad == "too_many_heads":
        q, kc, vc = (torch.zeros(2, 34, 32), torch.zeros(2, 16, 2, 32),
                     torch.zeros(2, 16, 2, 32))
    with pytest.raises(ValueError):
        check_decode(q, kc, vc, pos)


def test_resolve_device_raises_without_cuda_and_never_picks_the_cpu():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")

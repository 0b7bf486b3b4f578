"""K3 and K4 at the head widths the TPU kernels take (CPU, small shapes).

The Pallas kernels take any head width and a v of its own width; the
port's kernels are instantiated for the widths of the repo's configs:
K3 for q/k D in {32, 48, 64, 96, 112, 128, 192} and v Dv in {32, 64,
112, 128} in every pairing (zamba2-7b's 112/112, deepseek-v2's MLA
prefill 192/128, minicpm3-4b's 96/64, the reduced configs' 48/32), K4
for D and Dv in {32, 64, 112, 128}. Here the wrappers' checks are pinned,
and the plain versions at the new widths are held against
``repro/kernels/ref.py`` and the Pallas kernels in interpret mode on the
same numpy inputs, fp32, tolerance 1e-5. K4's split of the cache walk is
pinned too: its boundaries depend on the split length alone. The kernels
themselves run on the card (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 1e-5
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------- checks
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("Dv", fa.V_DIMS)
def test_flash_check_accepts_every_width_pairing(D, Dv):
    q, k = torch.zeros(1, 8, 4, D), torch.zeros(1, 8, 2, D)
    v = torch.zeros(1, 8, 2, Dv)
    fa.check_inputs(q, k, v)


def test_flash_widths_cover_the_configs_pairs():
    for D, Dv in ((112, 112), (192, 128), (96, 64), (48, 32), (128, 128)):
        assert D in fa.HEAD_DIMS and Dv in fa.V_DIMS


@pytest.mark.parametrize("D,Dv", [(40, 40), (100, 64), (256, 128),
                                  (128, 96), (192, 192), (112, 48)])
def test_flash_check_refuses_widths_it_is_not_built_for(D, Dv):
    q, k = torch.zeros(1, 8, 4, D), torch.zeros(1, 8, 2, D)
    v = torch.zeros(1, 8, 2, Dv)
    with pytest.raises(ValueError, match="not in"):
        fa.check_inputs(q, k, v)


@pytest.mark.parametrize("D", da.HEAD_DIMS)
@pytest.mark.parametrize("Dv", da.V_DIMS)
def test_decode_check_accepts_every_width_pairing(D, Dv):
    q = torch.zeros(2, 8, D)
    kc, vc = torch.zeros(2, 16, 2, D), torch.zeros(2, 16, 2, Dv)
    da.check_inputs(q, kc, vc, torch.zeros(2, dtype=torch.int32))
    da.check_inputs(q, kc, vc, 5)


@pytest.mark.parametrize("bad", ["rows", "slots", "heads", "dims", "width",
                                 "head_dim"])
def test_decode_check_refuses_a_v_cache_unlike_the_k_cache(bad):
    q, kc = torch.zeros(2, 8, 112), torch.zeros(2, 16, 2, 112)
    vc = {"rows": torch.zeros(3, 16, 2, 64),
          "slots": torch.zeros(2, 15, 2, 64),
          "heads": torch.zeros(2, 16, 4, 64),
          "dims": torch.zeros(2, 16, 2, 8, 8),
          "width": torch.zeros(2, 16, 2, 40),
          "head_dim": None}[bad]
    if bad == "head_dim":
        q, kc, vc = (torch.zeros(2, 8, 96), torch.zeros(2, 16, 2, 96),
                     torch.zeros(2, 16, 2, 96))
    with pytest.raises(ValueError):
        da.check_inputs(q, kc, vc, 3)


# ---------------------------------------------------------------- split
@pytest.mark.parametrize("S,n", [(1, 1), (40, 1), (63, 1), (64, 1), (65, 2),
                                 (300, 5), (544, 9), (1024, 16), (1025, 17)])
def test_decode_split_count_follows_the_capacity_alone(S, n):
    assert da.num_splits(S) == n


def test_decode_split_length_is_the_kernels():
    """The wrapper sizes the scratch from ``SPLIT``; the kernel refuses a
    call whose split count disagrees with its own constant."""
    src = (CSRC / "decode_attention.cu").read_text()
    assert int(re.search(r"constexpr int SPLIT = (\d+);", src).group(1)) == da.SPLIT
    assert int(re.search(r"constexpr int GMAX = (\d+);", src).group(1)) == da.GMAX


# ---------------------------------------------------------------- plain vs ref
FLASH_WIDE = [  # (B, Sq, Sk, H, Hkv, D, Dv, causal, window)
    (1, 96, 96, 4, 2, 112, 112, True, 0),     # zamba2-7b's width
    (1, 100, 100, 4, 2, 112, 112, True, 37),  # ragged, windowed
    (1, 80, 80, 4, 4, 192, 128, True, 0),     # deepseek-v2's MLA prefill
    (1, 70, 70, 2, 2, 192, 128, False, 0),    # non-causal, ragged
    (1, 64, 64, 4, 2, 96, 64, True, 20),      # minicpm3-4b's, windowed
]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,Dv,causal,window", FLASH_WIDE)
def test_plain_flash_at_the_new_widths_matches_reference_and_pallas(
        B, Sq, Sk, H, Hkv, D, Dv, causal, window):
    rng = np.random.default_rng(Sq * 31 + D + Dv)
    q, k, v = (_normal(rng, B, Sq, H, D), _normal(rng, B, Sk, Hkv, D),
               _normal(rng, B, Sk, Hkv, Dv))
    out = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   window=window)
    assert out.shape == (B, Sq, H, Dv)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                         window=window))
    _close(out, flash_attention_pallas(jq, jk, jv, causal=causal,
                                       window=window, block_q=64, block_k=64,
                                       interpret=True))


DECODE_WIDE = [  # (B, S, H, Hkv, D, Dv, pos)
    (2, 128, 4, 4, 112, 112, 80),
    (2, 160, 8, 2, 112, 64, 100),   # v narrower than k
    (2, 100, 8, 2, 64, 128, 99),    # v wider than k
    (3, 70, 28, 4, 128, 112, 0),    # qwen2's G = 7
    (2, 90, 16, 1, 32, 112, 89),    # pos at the last slot, MQA
]


@pytest.mark.parametrize("B,S,H,Hkv,D,Dv,pos", DECODE_WIDE)
def test_plain_decode_with_v_of_its_own_width_matches_reference_and_pallas(
        B, S, H, Hkv, D, Dv, pos):
    rng = np.random.default_rng(S + D + Dv)
    q, kc, vc = (_normal(rng, B, H, D), _normal(rng, B, S, Hkv, D),
                 _normal(rng, B, S, Hkv, Dv))
    out = tref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(kc),
                                    torch.from_numpy(vc), pos)
    assert out.shape == (B, H, Dv)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc)
    _close(out, jref.decode_attention_ref(jq, jk, jv, pos))
    _close(out, decode_attention_pallas(jq, jk, jv, pos, block_k=64,
                                        interpret=True))


def test_plain_decode_per_row_pos_with_v_unlike_k_matches_reference():
    """Row b at its own pos[b] against the reference at the scalar pos[b]."""
    B, S, H, Hkv, D, Dv, pos = 4, 130, 8, 2, 112, 64, [0, 63, 64, 129]
    rng = np.random.default_rng(11)
    q, kc, vc = (_normal(rng, B, H, D), _normal(rng, B, S, Hkv, D),
                 _normal(rng, B, S, Hkv, Dv))
    out = tref.decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.tensor(pos, dtype=torch.int32))
    for b, p in enumerate(pos):
        row = (jnp.asarray(q[b:b + 1]), jnp.asarray(kc[b:b + 1]),
               jnp.asarray(vc[b:b + 1]))
        _close(out[b:b + 1], jref.decode_attention_ref(*row, p))

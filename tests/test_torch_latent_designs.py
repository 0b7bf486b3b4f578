"""The decompositions of K5's and K6's bf16 kernels, as plain torch, against
the port's plain versions and the JAX package's (CPU, small shapes).

The kernels run only on the card; what they compute in which order is
mirrored here so that the order itself is held against the references:

* **Split-K MLA decode** (``csrc/mla_decode_bf16.cu`` and
  ``csrc/mla_decode.cu`` with ``split_combine.cuh``): each split of
  ``SPLIT`` slots gives (m, l, acc) in the log2 domain, splits past the
  row's filled length give nothing, and the combine sums the splits in
  split order. Held against ``repro_torch.kernels.ref`` and
  ``repro.kernels.ref`` within 1e-5 (fp32 inputs; only the summation order
  differs). A row with a negative pos gets zeros, as the kernels give;
  the plain versions average a fully masked row instead, which no caller
  asks for.
* **Three-phase SSD** (``csrc/ssd_scan_bf16.cu``): chunk-local states and
  C.B^T once per chunk, the carry over the chunks, then the outputs.
  Held against ``repro_torch.kernels.ref.ssd_scan_ref`` and
  ``repro.models.ssm.ssd_chunked`` within 1e-4 (``tests/test_kernels.py``'s
  scan tolerance), y and the final state. With bf16 inputs and the fp32
  operands split into bf16 high and low parts, as the kernel issues them,
  the final state stays within the card's 1e-4 (absolute and relative).
* **The wrappers' pure-Python helpers**: the split count and the scratch
  sizes.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import mla_decode as mk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402

MLA_TOL = 1e-5
SCAN_TOL = 1e-4  # tests/test_kernels.py:131-133
SSD_TOL = 1e-4   # chip_smoke.py's hold on K6's final state
LOG2E = 1.0 / math.log(2.0)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


# ------------------------------------------------------- split-K MLA decode
def _split_mla(q_lat, q_rope, c, kr, pos, scale, split):
    """Per row: the splits 0 .. ceil(n / split) - 1 of the n = min(pos, S -
    1) + 1 filled slots, each (m, l, acc) with m in the log2 domain, then
    the combine in split order."""
    B, H, R = q_lat.shape
    S = c.shape[1]
    rows = (pos.tolist() if isinstance(pos, torch.Tensor) else [int(pos)] * B)
    out = torch.zeros(B, H, R)
    for b, p in enumerate(rows):
        n = max(0, min(p, S - 1) + 1)
        parts = []
        for s0 in range(0, n, split):
            s1 = min(s0 + split, n)
            sc = (q_lat[b] @ c[b, s0:s1].T + q_rope[b] @ kr[b, s0:s1].T)
            sc = sc * (scale * LOG2E)
            m = sc.max(dim=-1).values
            pr = torch.exp2(sc - m[:, None])
            parts.append((m, pr.sum(-1), pr @ c[b, s0:s1]))
        if not parts:
            continue  # no slot: zeros
        M = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        den, num = torch.zeros(H), torch.zeros(H, R)
        for m, l, acc in parts:  # split order
            w = torch.exp2(m - M)
            den = den + l * w
            num = num + acc * w[:, None]
        out[b] = num / torch.clamp(den, min=1e-30)[:, None]
    return out


def _mla_inputs(B, S, H, R, Rr, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, R), (B, H, Rr), (B, S, R), (B, S, Rr))]


@pytest.mark.parametrize("S,H,R,Rr,pos", [
    (100, 5, 64, 16, 99),        # S not a multiple of the split; pos S - 1
    (100, 5, 64, 16, 0),         # pos 0: one slot
    (300, 17, 32, 32, 70),       # empty trailing splits
    (64, 3, 128, 64, 63),        # exactly one split
    (130, 40, 256, 32, [129, 0, 64, 63]),  # per-row, across split edges
    (200, 8, 512, 64, [5, 199]),
])
def test_split_k_mla_decode_matches_the_plain_versions(S, H, R, Rr, pos):
    arrs = _mla_inputs(len(pos) if isinstance(pos, list) else 2, S, H, R, Rr,
                       S + H)
    t = [torch.from_numpy(a) for a in arrs]
    p = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) else pos
    scale = 1.0 / math.sqrt(96)
    got = _split_mla(*t, p, scale, mk.SPLIT)
    _close(got, tref.mla_decode_attention_ref(*t, p, scale), MLA_TOL)
    rows = pos if isinstance(pos, list) else [pos] * len(arrs[0])
    for b, pb in enumerate(rows):  # the JAX reference takes a scalar pos
        one = [jnp.asarray(a[b:b + 1]) for a in arrs]
        _close(got[b:b + 1], jref.mla_decode_attention_ref(*one, pb, scale),
               MLA_TOL)


@pytest.mark.parametrize("pos", [-1, [-1, 30]])
def test_split_k_mla_decode_gives_zeros_for_a_negative_pos(pos):
    arrs = _mla_inputs(2, 70, 4, 32, 16, 3)
    t = [torch.from_numpy(a) for a in arrs]
    p = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) else pos
    got = _split_mla(*t, p, 0.2, mk.SPLIT)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    if isinstance(pos, list):
        _close(got[1:], tref.mla_decode_attention_ref(*t, p, 0.2)[1:],
               MLA_TOL)


def test_split_k_row_does_not_depend_on_the_capacity_or_the_batch():
    """The split boundaries are multiples of SPLIT, so a row cut to its
    filled slots, or decoded alone, splits the same way and sums the same
    partials in the same order: the same bits."""
    arrs = _mla_inputs(3, 300, 6, 64, 16, 11)
    t = [torch.from_numpy(a) for a in arrs]
    pos = [299, 64, 130]
    both = _split_mla(*t, torch.tensor(pos, dtype=torch.int32), 0.2, mk.SPLIT)
    for b, p in enumerate(pos):
        one = [x[b:b + 1] for x in t]
        assert torch.equal(_split_mla(*one, p, 0.2, mk.SPLIT), both[b:b + 1])
        cut = one[:2] + [one[2][:, :p + 1], one[3][:, :p + 1]]
        assert torch.equal(_split_mla(*cut, p, 0.2, mk.SPLIT), both[b:b + 1])


def test_split_count_and_scratch_follow_the_capacity():
    assert mk.SPLIT == 64
    assert [mk.num_splits(S) for S in (1, 63, 64, 65, 544)] == [1, 1, 1, 2, 9]
    assert mk.scratch_floats(4, 544, 40, 256) == 4 * 9 * 40 * 258


# ------------------------------------------------------- three-phase SSD
def _hi_lo(v):
    """An fp32 operand as the kernel issues it: bf16 high part plus bf16
    low part."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def _three_phase_ssd(x, dt, A_log, Bm, Cm, D, chunk, split=lambda v: v):
    """``ssd_scan_bf16.cu``'s order: (1) per chunk, the decay cumsum, C.B^T
    once for all heads and each head's local state; (2) the carry; (3) per
    chunk, y from C.B^T o L dt, the entering state and D x. ``split`` is
    applied to the fp32 operand of each product."""
    Bsz, S, H, P = x.shape
    nc = S // chunk
    xc = x.float().reshape(Bsz, nc, chunk, H, P)
    dtc = dt.float().reshape(Bsz, nc, chunk, H)
    Bc = Bm.float().reshape(Bsz, nc, chunk, -1)
    Cc = Cm.float().reshape(Bsz, nc, chunk, -1)
    cum = torch.cumsum(-torch.exp(A_log.float()) * dtc, dim=2)  # (B, nc, Q, H)
    total = cum[:, :, -1]                                        # (B, nc, H)
    # phase 1
    cb = Cc @ Bc.transpose(-1, -2)                               # (B, nc, Q, Q)
    w = torch.exp(total[:, :, None] - cum) * dtc                 # (B, nc, Q, H)
    xw = split(w[..., None] * xc)                                # (B, nc, Q, H, P)
    local = torch.einsum("bcjhp,bcjn->bchpn", xw, Bc)
    # phase 2
    run = torch.zeros_like(local[:, 0])
    s_in = []
    for c in range(nc):
        s_in.append(run)
        run = run * torch.exp(total[:, c])[..., None, None] + local[:, c]
    s_in = torch.stack(s_in, dim=1)                              # (B, nc, H, P, N)
    # phase 3
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    dec = torch.exp(cum[:, :, :, None] - cum[:, :, None, :])     # (B, nc, Q, Q, H)
    a = torch.where(tril[None, None, :, :, None],
                    cb[..., None] * dec * dtc[:, :, None, :, :], 0.0)
    y = torch.einsum("bcijh,bcjhp->bcihp", split(a), xc)
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bcin,bchpn->bcihp", Cc, split(s_in))
    y = y.reshape(Bsz, S, H, P) + D.float()[None, None, :, None] * x.float()
    return y, run


def _ssd_inputs(B, S, H, N, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, 64)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0)).astype(np.float32)
    A_log = np.log(np.arange(1, H + 1, dtype=np.float32))
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    D = np.ones(H, np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, A_log, Bm, Cm, D)]
    for i in (0, 3, 4):  # x, B and C in the kernel's dtype
        t[i] = t[i].to(dtype)
    return t


@pytest.mark.parametrize("N", sk.STATE_DIMS)
@pytest.mark.parametrize("chunk", [1, 7, 32, 100, 128])
def test_three_phase_ssd_matches_the_plain_versions(N, chunk):
    B, H = 2, 3
    S = 3 * chunk if chunk < 100 else 2 * chunk
    t = _ssd_inputs(B, S, H, N, N + chunk)
    y, state = _three_phase_ssd(*t, chunk)
    y_ref, s_ref = tref.ssd_scan_ref(*t, chunk=chunk)
    _close(y, y_ref, SCAN_TOL)
    _close(state, s_ref, SCAN_TOL)
    jy, js = jssm.ssd_chunked(*[jnp.asarray(a.numpy()) for a in t],
                              chunk=chunk)
    _close(y, jy, SCAN_TOL)
    _close(state, js, SCAN_TOL)


@pytest.mark.parametrize("N,chunk", [(128, 128), (16, 100), (64, 7)])
def test_three_phase_ssd_with_hi_lo_operands_keeps_the_state_tolerance(
        N, chunk):
    """bf16 inputs; each fp32 operand split into bf16 high and low parts as
    the kernel issues it: the final state within 1e-4 absolute and relative
    of the plain version (chip_smoke's SSD_TOL) and y within bf16's 2e-2."""
    B, H = 2, 4
    t = _ssd_inputs(B, 4 * chunk if chunk < 100 else 2 * chunk, H, N,
                    N * chunk, dtype=torch.bfloat16)
    y, state = _three_phase_ssd(*t, chunk, split=_hi_lo)
    y_ref, s_ref = tref.ssd_scan_ref(t[0].float(), t[1], t[2], t[3].float(),
                                     t[4].float(), t[5], chunk=chunk)
    torch.testing.assert_close(state, s_ref, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(y.to(torch.bfloat16).float(), y_ref,
                               rtol=2e-2, atol=2e-2)


def test_ssd_scratch_holds_the_states_the_scores_and_the_totals():
    # mamba2-370m's 512-token prefill: 4 chunks of 128
    floats = sk.scratch_floats(1, 512, 32, 128, 128)
    assert floats == 4 * (32 * 64 * 128 + 128 * 128 + 32)
    assert floats * 4 == 4_456_960  # bytes: 4 MiB of states, 256 KiB of C.B^T
    assert sk.LIBRARIES == {torch.float32: "ssd_scan",
                            torch.bfloat16: "ssd_scan_bf16"}

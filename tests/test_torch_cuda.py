"""The port on the card: hand-written kernels against their plain versions,
the reduced qwen2, minicpm3-4b and mamba2-370m and the full-size
``paac_nature`` on the card against the same weights on the CPU, one
training iteration through K1, and the pipeline: five async updates
through K2, and lockstep with infinite clips bitwise equal to
``ParallelRL`` through K1; the other agents (DQN, lagged PAAC in both
modes, PPO) each with one update on the card against the CPU, and the
trainer's three legs with their K1 and K2 launches; the host env plane:
``HostEnvPool`` snapshots on the card that never alias, page-locked
staging sets, the sync host ``ParallelRL`` through K1 and the pipelined
host plane through K2, lockstep ≡ sync bitwise, a NaN-poisoned release
changing nothing, and the trainer's ``--host-env`` legs; the process
actor plane: one spawned worker acting on the card in lockstep ≡ the
thread host plane bitwise, two workers through K2, nothing left behind.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. This file imports no JAX, so it also runs on a machine that has
none: from the repository root,
``PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py``.
Tolerances: fp32 1e-4; bf16 2e-2 (absolute and relative) against the
plain version in fp32 on the same bf16 inputs; logits 1e-4; n-step
returns and V-trace targets bitwise (the kernels round each operation as
the plain versions do). TF32 is off for matmuls and convolutions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.mla_decode import mla_decode_attention_cuda  # noqa: E402
from repro_torch.kernels.nstep_returns import nstep_returns_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_cuda  # noqa: E402
from repro_torch.kernels.vtrace import vtrace_returns_cuda  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dt):
    return 1e-4 if dt == torch.float32 else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", [
    (1, 77, 77, 28, 4, 128, True, 0),
    (2, 100, 100, 8, 1, 64, True, 37),
    (2, 96, 96, 4, 4, 32, False, 0),
    (1, 60, 150, 14, 2, 128, True, 20),
])
def test_flash_kernel_matches_plain_version(cuda, dtype, B, Sq, Sk, H, Hkv,
                                            D, causal, window):
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(Sq)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dt)
    k = torch.randn(B, Sk, Hkv, D, generator=g, device=cuda).to(dt)
    v = torch.randn(B, Sk, Hkv, D, generator=g, device=cuda).to(dt)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert got.dtype == dt
    torch.testing.assert_close(got.float(), want, rtol=_tol(dt), atol=_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,pos", [
    (4, 300, 28, 4, 128, [0, 63, 64, 299]),
    (4, 300, 28, 4, 128, 150),
    (3, 100, 16, 1, 64, [5, 99, 50]),
    (2, 40, 4, 4, 32, [39, 0]),
])
def test_decode_kernel_matches_plain_version(cuda, dtype, B, S, H, Hkv, D,
                                             pos):
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(S)
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dt)
    kc = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dt)
    vc = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dt)
    p = (torch.tensor(pos, dtype=torch.int32, device=cuda)
         if isinstance(pos, list) else pos)
    want = ref.decode_attention_ref(q.float(), kc.float(), vc.float(), p)
    got = decode_attention_cuda(q, kc, vc, p)
    torch.testing.assert_close(got.float(), want, rtol=_tol(dt), atol=_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,D,Dv", [
    (1, 130, 40, 96, 64),  # minicpm3-4b's MLA prefill, ragged S
    (2, 70, 4, 48, 32),    # reduced minicpm3-4b
    (1, 64, 8, 32, 128),
])
def test_flash_kernel_with_v_unlike_qk_matches_plain_version(cuda, dtype, B, S,
                                                              H, D, Dv):
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(S + D)
    q = torch.randn(B, S, H, D, generator=g, device=cuda).to(dt)
    k = torch.randn(B, S, H, D, generator=g, device=cuda).to(dt)
    v = torch.randn(B, S, H, Dv, generator=g, device=cuda).to(dt)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float())
    got = flash_attention_cuda(q, k, v)
    assert got.shape == (B, S, H, Dv) and got.dtype == dt
    torch.testing.assert_close(got.float(), want, rtol=_tol(dt), atol=_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,Dv,causal,window", [
    (1, 150, 150, 8, 2, 112, 112, True, 0),    # zamba2-7b's width, ragged
    (2, 100, 100, 8, 2, 112, 112, True, 37),   # windowed
    (1, 77, 77, 4, 4, 192, 128, True, 0),      # deepseek-v2's MLA prefill
    (1, 130, 130, 4, 4, 192, 128, True, 50),
    (1, 96, 96, 4, 2, 192, 128, False, 0),     # non-causal
    (1, 60, 150, 8, 4, 112, 64, True, 20),     # Sq < Sk
    (1, 200, 200, 6, 3, 48, 112, True, 0),     # v wider than q/k
    (1, 1, 1, 4, 2, 112, 112, True, 0),        # one query, one key
    (2, 3, 70, 4, 4, 192, 128, False, 0),      # a few queries, one tile
])
def test_flash_kernel_at_the_tpu_kernels_widths_matches_plain_version(
        cuda, dtype, B, Sq, Sk, H, Hkv, D, Dv, causal, window):
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(Sq + D + Dv)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dt)
    k = torch.randn(B, Sk, Hkv, D, generator=g, device=cuda).to(dt)
    v = torch.randn(B, Sk, Hkv, Dv, generator=g, device=cuda).to(dt)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert got.shape == (B, Sq, H, Dv) and got.dtype == dt
    torch.testing.assert_close(got.float(), want, rtol=_tol(dt), atol=_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,Dv,pos", [
    (4, 200, 8, 2, 112, 112, [0, 63, 64, 199]),  # S above one split
    (3, 64, 8, 2, 112, 64, [0, 31, 63]),         # S at one split, Dv < D
    (3, 40, 4, 4, 64, 128, [39, 0, 17]),         # S below one split, Dv > D
    (2, 150, 28, 4, 128, 112, [149, 77]),
    (2, 150, 16, 1, 32, 32, 90),                 # scalar pos, MQA
    (2, 100, 8, 2, 112, 128, 500),               # pos past S: every slot
    (3, 1, 8, 2, 112, 64, [0, 0, 7]),            # a cache of one slot
])
def test_decode_kernel_at_the_tpu_kernels_widths_matches_plain_version(
        cuda, dtype, B, S, H, Hkv, D, Dv, pos):
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(S + D + Dv)
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dt)
    kc = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dt)
    vc = torch.randn(B, S, Hkv, Dv, generator=g, device=cuda).to(dt)
    p = (torch.tensor(pos, dtype=torch.int32, device=cuda)
         if isinstance(pos, list) else pos)
    want = ref.decode_attention_ref(q.float(), kc.float(), vc.float(), p)
    got = decode_attention_cuda(q, kc, vc, p)
    assert got.shape == (B, H, Dv) and got.dtype == dt
    torch.testing.assert_close(got.float(), want, rtol=_tol(dt), atol=_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_row_is_bitwise_the_same_alone_or_beside_others(
        cuda, dtype):
    """Split boundaries depend on nothing but the split length, so a row's
    output does not move with the batch, the other rows' positions or the
    cache's capacity: the serving pin continuous == solo rests on it."""
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(7)
    B, S, H, Hkv, D = 4, 544, 28, 4, 128
    q = torch.randn(B, H, D, generator=g, device=cuda).to(dt)
    kc = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dt)
    vc = torch.randn(B, S, Hkv, D, generator=g, device=cuda).to(dt)
    pos = [256, 300, 64, 543]
    both = decode_attention_cuda(q, kc, vc,
                                 torch.tensor(pos, dtype=torch.int32,
                                              device=cuda))
    for b, p in enumerate(pos):
        alone = decode_attention_cuda(
            q[b:b + 1].contiguous(), kc[b:b + 1].contiguous(),
            vc[b:b + 1].contiguous(),
            torch.tensor([p], dtype=torch.int32, device=cuda))
        assert torch.equal(alone, both[b:b + 1])
        # a shorter cache holding the same filled slots
        cut = decode_attention_cuda(
            q[b:b + 1].contiguous(), kc[b:b + 1, :p + 1].contiguous(),
            vc[b:b + 1, :p + 1].contiguous(), p)
        assert torch.equal(cut, both[b:b + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W,S,H,R,Rr,pos", [
    (4, 544, 40, 256, 32, [127, 250, 399, 543]),  # minicpm3-4b, per-row pos
    (4, 544, 40, 256, 32, 300),                   # scalar pos
    (3, 70, 4, 32, 16, [0, 33, 69]),              # reduced minicpm3-4b
    (2, 100, 128, 512, 64, 99),                   # deepseek-v2's widths
    # the split design's edges
    (2, 544, 128, 512, 64, [543, 100]),   # R split over warps, many splits
    (1, 1, 1, 64, 16, 0),                 # one slot, one head
    (3, 63, 17, 128, 32, [62, 0, 31]),    # S below one split, H % 16 != 0
    (2, 65, 40, 256, 32, [64, 63]),       # one slot into the second split
    (2, 65, 17, 32, 16, 64),              # scalar pos, R = 32 (8 columns a warp)
    (4, 544, 1, 256, 64, [543, 0, 64, 300]),
    (2, 100, 40, 256, 32, 5000),          # pos past the capacity: all slots
] + [(2, 130, 20, R, Rr, [129, 70])      # every latent and rope width
     for R in (32, 64, 128, 256, 512) for Rr in (16, 32, 64)])
def test_mla_kernel_matches_plain_version(cuda, dtype, W, S, H, R, Rr, pos):
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(S + H)
    ql, qr = (torch.randn(W, H, d, generator=g, device=cuda).to(dt)
              for d in (R, Rr))
    c, kr = (torch.randn(W, S, d, generator=g, device=cuda).to(dt)
             for d in (R, Rr))
    p = (torch.tensor(pos, dtype=torch.int32, device=cuda)
         if isinstance(pos, list) else pos)
    scale = 1.0 / (96 ** 0.5)
    want = ref.mla_decode_attention_ref(ql.float(), qr.float(), c.float(),
                                        kr.float(), p, scale)
    got = mla_decode_attention_cuda(ql, qr, c, kr, p, scale)
    assert got.dtype == dt
    torch.testing.assert_close(got.float(), want, rtol=_tol(dt), atol=_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,N,chunk", [
    (1, 512, 32, 128, 128),  # mamba2-370m prefill
    (2, 64, 8, 16, 32),      # reduced mamba2-370m
    (1, 100, 4, 32, 100),    # one chunk shorter than 128
] + [(2, 3 * Q if Q < 100 else 2 * Q, 6, N, Q)  # every N, chunks of any length
     for N in (16, 32, 64, 128) for Q in (7, 32, 100, 128)])
def test_ssd_kernel_matches_plain_version(cuda, dtype, B, S, H, N, chunk):
    """y within 1e-4 + 1e-4 |y| (fp32; C.B^T sums of 128 terms reach |y| ~
    100) or 2e-2 + 2e-2 |y| (bf16 output), the fp32 state within 1e-4 +
    1e-4 |state| (SSD_TOL) in both dtypes."""
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(S + N)
    x = torch.randn(B, S, H, 64, generator=g, device=cuda).to(dt)
    dts = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device=cuda) - 2.0)
    A = torch.log(torch.arange(1, H + 1, device=cuda, dtype=torch.float32))
    Bm, Cm = (torch.randn(B, S, N, generator=g, device=cuda).to(dt)
              for _ in range(2))
    D = torch.ones(H, device=cuda)
    y, state = ssd_scan_cuda(x, dts, A, Bm, Cm, D, chunk=chunk)
    y_ref, s_ref = ref.ssd_scan_ref(x.float(), dts, A, Bm.float(), Cm.float(),
                                    D, chunk=chunk)
    assert y.dtype == dt and state.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref, rtol=_tol(dt), atol=_tol(dt))
    torch.testing.assert_close(state, s_ref, rtol=1e-4, atol=1e-4)


def _mla_inputs(cuda, dt, W, S, H, R, Rr, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    ql, qr = (torch.randn(W, H, d, generator=g, device=cuda).to(dt)
              for d in (R, Rr))
    c, kr = (torch.randn(W, S, d, generator=g, device=cuda).to(dt)
             for d in (R, Rr))
    return ql, qr, c, kr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_kernel_gives_zeros_for_a_negative_pos(cuda, dtype):
    """A row whose pos is negative sees no slot: every split exits and the
    combine writes zeros (the plain version would average a fully masked
    row); the other rows are unaffected."""
    dt = getattr(torch, dtype)
    W, S, H, R, Rr = 3, 100, 40, 256, 32
    ql, qr, c, kr = _mla_inputs(cuda, dt, W, S, H, R, Rr, 3)
    got = mla_decode_attention_cuda(ql, qr, c, kr, -1, 0.1)
    assert torch.equal(got, torch.zeros_like(got))
    p = torch.tensor([-5, 40, 99], dtype=torch.int32, device=cuda)
    got = mla_decode_attention_cuda(ql, qr, c, kr, p, 0.1)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = ref.mla_decode_attention_ref(ql.float(), qr.float(), c.float(),
                                        kr.float(), p, 0.1)
    torch.testing.assert_close(got[1:].float(), want[1:], rtol=_tol(dt),
                               atol=_tol(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_kernel_row_is_bitwise_the_same_alone_or_beside_others(
        cuda, dtype):
    """K4's pin for K5: split boundaries depend on nothing but the split
    length, so a row's output does not move with the batch, the other rows'
    positions or the cache's capacity."""
    dt = getattr(torch, dtype)
    W, S, H, R, Rr = 4, 544, 40, 256, 32
    ql, qr, c, kr = _mla_inputs(cuda, dt, W, S, H, R, Rr, 7)
    pos = [256, 300, 64, 543]
    both = mla_decode_attention_cuda(
        ql, qr, c, kr, torch.tensor(pos, dtype=torch.int32, device=cuda), 0.1)
    for b, p in enumerate(pos):
        one = (slice(b, b + 1),)
        alone = mla_decode_attention_cuda(
            ql[one].contiguous(), qr[one].contiguous(), c[one].contiguous(),
            kr[one].contiguous(),
            torch.tensor([p], dtype=torch.int32, device=cuda), 0.1)
        assert torch.equal(alone, both[b:b + 1])
        # a shorter cache holding the same filled slots
        cut = mla_decode_attention_cuda(
            ql[one].contiguous(), qr[one].contiguous(),
            c[b:b + 1, :p + 1].contiguous(), kr[b:b + 1, :p + 1].contiguous(),
            p, 0.1)
        assert torch.equal(cut, both[b:b + 1])


@pytest.mark.cuda
def test_dispatch_counts_only_kernel_launches(cuda):
    q = torch.zeros(1, 8, 4, 32, device=cuda)
    k = torch.zeros(1, 8, 2, 32, device=cuda)
    ops.reset_launches()
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, 0].contiguous(), k, k, 3)
    ops.flash_attention(q.cpu(), k.cpu(), k.cpu())
    assert ops.launches == {"nstep_returns": 0, "vtrace_returns": 0,
                            "flash_attention": 1, "decode_attention": 1,
                            "mla_decode_attention": 0, "ssd_scan": 0}
    with pytest.raises(ValueError):  # no fallback: a bad input raises
        ops.flash_attention(q.half(), k.half(), k.half())


@pytest.mark.cuda
def test_reduced_qwen2_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import init_policy, policy_decode, policy_prefill

    cfg = get_config("qwen2-7b").reduced()
    cpu = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    gpu = to(cpu, cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 21)))
    lc, _, cc = policy_prefill(cpu, cfg, toks, max_len=32)
    lg, _, cg = policy_prefill(gpu, cfg, toks.to(cuda), max_len=32)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for pos in (torch.tensor([21, 25], dtype=torch.int32), 26):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
        pg = pos.to(cuda) if isinstance(pos, torch.Tensor) else pos
        lc, _, cc = policy_decode(cpu, cfg, cc, tok, pos)
        lg, _, cg = policy_decode(gpu, cfg, cg, tok.to(cuda), pg)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,absorb,kernel", [
    ("minicpm3-4b", True, "mla_decode_attention"),
    ("minicpm3-4b", False, "flash_attention"),
    ("mamba2-370m", False, "ssd_scan"),
])
def test_reduced_mla_and_ssm_on_the_card_match_the_cpu(cuda, arch, absorb,
                                                       kernel):
    from repro_torch.configs import get_config
    from repro_torch.models import init_policy, policy_decode, policy_prefill

    cfg = get_config(arch).reduced().replace(mla_absorb=absorb)
    cpu = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    ops.reset_launches()
    lc, _, cc = policy_prefill(cpu, cfg, toks, max_len=72)
    lg, _, cg = policy_prefill(gpu, cfg, toks.to(cuda), max_len=72)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for pos in (torch.tensor([64, 60], dtype=torch.int32), 65):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
        pg = pos.to(cuda) if isinstance(pos, torch.Tensor) else pos
        lc, _, cc = policy_decode(cpu, cfg, cc, tok, pos)
        lg, _, cg = policy_decode(gpu, cfg, cg, tok.to(cuda), pg)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    assert ops.launches[kernel] >= cfg.num_layers


def _bitwise(got, want):
    """Equal bit for bit where a number, NaN in the same places."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


# (E, T): the training path's n_e = 32 and 256 at t_max = 5, the TPU
# kernel's design point T = 4096 at E = 256, the first T past the short
# kernel's (16) and ragged tiles across a chunk edge (K1's chunk is 128
# steps, K2's 64)
@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.99, 1.0])
@pytest.mark.parametrize("E,T", [(1, 1), (33, 5), (256, 64), (4096, 5),
                                 (32, 5), (256, 5), (256, 4096), (31, 17),
                                 (33, 129), (4097, 259)])
def test_nstep_kernel_matches_plain_version(cuda, E, T, gamma):
    g = torch.Generator(cuda).manual_seed(E + T)
    r = torch.randn(T, E, generator=g, device=cuda)
    d = torch.rand(T, E, generator=g, device=cuda) < 0.1
    if E >= 2:
        d[:, 0], d[:, 1] = True, False
    b = torch.randn(E, generator=g, device=cuda)
    got = nstep_returns_cuda(r, d, b, gamma)
    want = ref.nstep_returns_ref(r, d, b, gamma)
    _bitwise(got, want)
    with pytest.raises(ValueError):  # no fallback: a bad input raises
        nstep_returns_cuda(r, d, b.requires_grad_(True), gamma)


def _unaligned(x):
    """``x`` in a contiguous view one element past an aligned allocation."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("T", [5, 65, 259])
def test_returns_kernels_take_misaligned_views_bitwise(cuda, T):
    """Inputs that start one element past an aligned address (E = 256, so
    only the pointer is off) take the kernels' cp.async and byte-load
    routes; the outputs are the plain versions' bit for bit."""
    g = torch.Generator(cuda).manual_seed(T)
    E = 256
    r, v = (torch.randn(T, E, generator=g, device=cuda) for _ in range(2))
    d = torch.rand(T, E, generator=g, device=cuda) < 0.1
    rho = torch.exp(0.5 * torch.randn(T, E, generator=g, device=cuda))
    b = torch.randn(E, generator=g, device=cuda)
    ur, ud, uv, urho = (_unaligned(x) for x in (r, d, v, rho))
    assert ur.data_ptr() % 16 and ud.data_ptr() % 4
    _bitwise(nstep_returns_cuda(ur, ud, b, 0.99),
             ref.nstep_returns_ref(r, d, b, 0.99))
    for x, y in zip(vtrace_returns_cuda(ur, ud, uv, b, urho, 0.99),
                    ref.vtrace_returns_ref(r, d, v, b, rho, 0.99)):
        _bitwise(x, y)


def _paac_nature(device, n_envs):
    from repro_torch.configs import get_config
    from repro_torch.core.agents import PAACAgent, PAACConfig
    from repro_torch.envs import AtariLike, FrameStack

    env = FrameStack(AtariLike(n_envs, device=device), 4)
    cfg = get_config("paac_nature").replace(obs_shape=env.obs_shape,
                                            num_actions=env.num_actions)
    return env, PAACAgent(cfg, PAACConfig(t_max=5))


@pytest.mark.cuda
def test_one_training_iteration_on_the_card_launches_k1_once(cuda):
    import math

    from repro_torch.core import ParallelRL

    env, agent = _paac_nature(cuda, 8)
    rl = ParallelRL(env, agent, seed=0, device=cuda)
    before = [t.clone() for t in tree_leaves(rl.params)]
    ops.reset_launches()
    res = rl.run(1)
    assert ops.launches["nstep_returns"] == 1
    assert all(t.is_cuda for t in tree_leaves(rl.params))
    assert all(math.isfinite(v) for v in res.mean_metrics.values())
    assert not all(torch.equal(a, b) for a, b in zip(before, tree_leaves(rl.params)))


@pytest.mark.cuda
def test_paac_nature_on_the_card_matches_the_cpu(cuda):
    from repro_torch.models import init_policy, policy_apply

    _, agent = _paac_nature("cpu", 1)
    cpu = init_policy(agent.cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    obs = torch.rand(32, 84, 84, 4, generator=torch.Generator().manual_seed(1))
    lc, vc, _ = policy_apply(cpu, agent.cfg, obs)
    lg, vg, _ = policy_apply(gpu, agent.cfg, obs.to(cuda))
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(vg.cpu(), vc, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.99, 1.0])
@pytest.mark.parametrize("rho_bar,c_bar", [(1.0, 1.0), (2.0, 1.0),
                                           (1e9, 1e9),
                                           (float("inf"), float("inf"))])
@pytest.mark.parametrize("E,T", [(1, 1), (33, 5), (256, 64), (4096, 5),
                                 (32, 5), (256, 5), (256, 4096), (31, 17),
                                 (33, 65), (4097, 131)])
def test_vtrace_kernel_matches_plain_version(cuda, E, T, rho_bar, c_bar,
                                             gamma):
    g = torch.Generator(cuda).manual_seed(E + T)
    r = torch.randn(T, E, generator=g, device=cuda)
    d = torch.rand(T, E, generator=g, device=cuda) < 0.1
    v = torch.randn(T, E, generator=g, device=cuda)
    rho = torch.exp(0.5 * torch.randn(T, E, generator=g, device=cuda))
    if E >= 3:
        d[:, 0], d[:, 1], rho[:, 2] = True, False, 50.0
    b = torch.randn(E, generator=g, device=cuda)
    got = vtrace_returns_cuda(r, d, v, b, rho, gamma, rho_bar, c_bar)
    want = ref.vtrace_returns_ref(r, d, v, b, rho, gamma, rho_bar, c_bar)
    for x, y in zip(got, want):
        # unclipped c on the rho = 50 row overflows float32 in both
        # versions over long T: the same inf and nan in the same places
        _bitwise(x, y)
    with pytest.raises(ValueError):  # no fallback: a bad input raises
        vtrace_returns_cuda(r, d, v.requires_grad_(True), b, rho, gamma)


def _pipelined(cuda, iters, **pipeline):
    from repro_torch.configs import PipelineConfig
    from repro_torch.pipeline import PipelinedRL

    env, agent = _paac_nature(cuda, 8)
    prl = PipelinedRL(env, agent, seed=0, device=cuda,
                      pipeline=PipelineConfig(**pipeline))
    before = [t.clone() for t in tree_leaves(prl.params)]
    ops.reset_launches()
    res = prl.run(iters)
    return prl, res, dict(ops.launches), before


@pytest.mark.cuda
def test_five_async_updates_on_the_card_launch_k2_five_times(cuda):
    import math

    prl, res, launches, before = _pipelined(cuda, 5, queue_depth=2)
    assert launches["vtrace_returns"] == 5 and launches["nstep_returns"] == 0
    assert sorted(prl.learned_ids) == [(0, s) for s in range(5)]
    assert all(math.isfinite(v) for v in res.mean_metrics.values())
    assert all(t.is_cuda for t in tree_leaves(prl.params))
    assert not all(torch.equal(a, b) for a, b in zip(before,
                                                      tree_leaves(prl.params)))


@pytest.mark.cuda
def test_lockstep_infinite_clips_on_the_card_is_parallel_rl_bitwise(
        cuda, monkeypatch):
    from repro_torch.core import ParallelRL

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    inf = float("inf")
    prl, res, launches, _ = _pipelined(cuda, 4, queue_depth=1, lockstep=True,
                                       rho_bar=inf, c_bar=inf)
    assert launches["nstep_returns"] == 4 and launches["vtrace_returns"] == 0
    env, agent = _paac_nature(cuda, 8)
    rl = ParallelRL(env, agent, seed=0, device=cuda)
    sync = rl.run(4)
    for k in ("loss", "policy_loss", "value_loss", "entropy", "reward_sum"):
        assert res.mean_metrics[k] == sync.mean_metrics[k], k
    for a, b in zip(tree_leaves(rl.params), tree_leaves(prl.params)):
        assert torch.equal(a, b)


def _replayed():
    """paac_nature params, a second set (stale copy / target network), an
    8-env trajectory of 8 steps and a replayed batch of 32 on the CPU."""
    from repro_torch.core.agents import replay
    from repro_torch.models import init_policy

    env, agent = _paac_nature("cpu", 8)
    cfg = agent.cfg
    params = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    other = init_policy(cfg, generator=torch.Generator().manual_seed(2),
                        device="cpu")
    g = torch.Generator().manual_seed(0)
    state = env.reset(g)
    collect = type(agent)(cfg, agent.hp._replace(t_max=8)).make_collect_step(
        env)
    _, _, traj, boot = collect(params, state, env.observe(state),
                               torch.Generator().manual_seed(1), g)
    buf = replay.replay_init(64, env.obs_shape, device="cpu")
    for t in range(7):
        replay.replay_add(buf, traj.obs[t], traj.action[t], traj.reward[t],
                          traj.obs[t + 1], traj.done[t])
    batch = replay.replay_sample(buf, torch.Generator().manual_seed(0), 32)
    return cfg, params, other, traj, boot, batch


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dqn", "lagged grad", "lagged act", "ppo"])
def test_other_agents_update_on_the_card_matches_the_cpu(cuda, name):
    from repro_torch.core.agents import (DQNAgent, DQNConfig, LaggedConfig,
                                         LaggedPAACAgent, PPOAgent,
                                         PPOConfig)
    from repro_torch.optim import constant, make_optimizer

    cfg, params, other, traj, boot, batch = _replayed()
    opt, lr = make_optimizer("rmsprop"), constant(0.0056)

    def run(dev):
        to = lambda t: tree_map(lambda x: x.to(dev), t)  # noqa: E731
        p, o = to(params), to(other)
        tr, b = type(traj)(*(x.to(dev) for x in traj)), boot.to(dev)
        if name == "dqn":
            agent = DQNAgent(cfg, DQNConfig(batch_size=32))
            new, _, _, m = agent.make_update_step(opt, lr)(
                p, opt.init(p), {"target": o, "updates": 0}, to(batch), 0)
        elif name == "ppo":
            agent = PPOAgent(cfg, PPOConfig(t_max=8, epochs=4))
            new, _, m = agent.make_update_step(opt, lr)(p, opt.init(p), tr, b,
                                                        0)
        else:
            agent = LaggedPAACAgent(cfg, LaggedConfig(t_max=8, delay=4),
                                    name.split()[1])
            new, _, _, m = agent.make_lagged_update(opt, lr)(
                p, opt.init(p), {"stale": o, "since": 0}, tr, b, 0)
        return m, new

    m_c, new_c = run("cpu")
    ops.reset_launches()
    m_g, new_g = run(cuda)
    want_k1 = 1 if name.startswith("lagged") else 0
    assert ops.launches["nstep_returns"] == want_k1
    assert ops.launches["vtrace_returns"] == 0
    assert all(t.is_cuda for t in tree_leaves(new_g))
    torch.testing.assert_close(m_g["loss"].cpu(), m_c["loss"], rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(tree_leaves(new_c), tree_leaves(new_g)):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("leg,kernel", [([], "nstep_returns"),
                                        (["--pipeline"], "vtrace_returns"),
                                        (["--algo", "dqn"], None)],
                         ids=["paac", "pipeline", "dqn"])
def test_the_trainers_legs_on_the_card_launch_their_kernels(cuda, leg,
                                                             kernel):
    import math

    from repro_torch.launch import train

    ops.reset_launches()
    (res,) = train.main(["--n-envs", "32", "--t-max", "5", "--iterations",
                         "6"] + leg)
    want = {k: 6 if k == kernel else 0 for k in ops.launches}
    assert dict(ops.launches) == want
    assert res.steps == 6 * 32 * 5
    assert all(math.isfinite(v) for v in res.mean_metrics.values())


def _host_pool(cuda, n=8, obs_dim=8):
    from repro_torch.envs import py_bound_spec

    return py_bound_spec(n, obs_dim=obs_dim, n_workers=4,
                         device=str(cuda)).build()


def _host_agent(obs_dim=8):
    from repro_torch.configs import get_config
    from repro_torch.core.agents import PAACAgent, PAACConfig

    cfg = get_config("paac_vector").replace(obs_shape=(obs_dim,),
                                            num_actions=3)
    return PAACAgent(cfg, PAACConfig(t_max=5))


@pytest.mark.cuda
def test_host_pool_snapshots_live_on_the_card_and_never_alias(cuda):
    from repro_torch.pipeline import HostStagingRing

    with _host_pool(cuda) as pool:
        obs = pool.reset()
        out = pool.step(np.zeros(8, np.int64))
        assert obs.is_cuda and all(t.is_cuda for t in out)
        snap = [t.clone() for t in (obs,) + out]
        for _ in range(12):  # dones and auto-resets included
            pool.step_host(np.ones(8, np.int64))
        assert all(torch.equal(a, b) for a, b in zip((obs,) + out, snap))
    s = HostStagingRing(2, 5, 8, (8,), np.float32, pin_memory=True).acquire()
    assert all(t.is_pinned() for t in s.traj + (s.last_obs,))
    s.np_traj.reward[0, 0] = 3.0
    assert float(s.traj.reward[0, 0]) == 3.0


@pytest.mark.cuda
def test_sync_host_and_pipelined_host_launch_k1_and_k2(cuda):
    import math

    from repro_torch.configs import PipelineConfig
    from repro_torch.core import ParallelRL
    from repro_torch.pipeline import PipelinedRL

    with _host_pool(cuda) as pool:
        ops.reset_launches()
        res = ParallelRL(pool, _host_agent()).run(4)
        assert ops.launches["nstep_returns"] == 4
        assert ops.launches["vtrace_returns"] == 0
        assert math.isfinite(res.mean_metrics["loss"])
        for n_act, depth in ((1, 2), (4, 4)):
            ops.reset_launches()
            prl = PipelinedRL(pool, _host_agent(), pipeline=PipelineConfig(
                queue_depth=depth, num_actors=n_act))
            res = prl.run(8)
            assert ops.launches["vtrace_returns"] == 8
            assert ops.launches["nstep_returns"] == 0
            assert sorted(prl.learned_ids) == [(a, s) for a in range(n_act)
                                               for s in range(8 // n_act)]
            assert all(math.isfinite(v) for v in res.mean_metrics.values())


@pytest.mark.cuda
@pytest.mark.parametrize("poison", [False, True], ids=["clean", "poisoned"])
def test_host_lockstep_on_the_card_is_sync_bitwise(cuda, poison,
                                                   monkeypatch):
    """Lockstep at infinite clips on a host pool ≡ the sync host run, bit
    for bit; with every staging set overwritten with NaN the moment it is
    released, too: release waits for the update's copy of the set."""
    from repro_torch.configs import PipelineConfig
    from repro_torch.core import ParallelRL
    from repro_torch.pipeline import HostStagingRing, PipelinedRL

    inf = float("inf")
    with _host_pool(cuda) as pool:
        rl = ParallelRL(pool, _host_agent(), seed=3)
        r_sync = rl.run(6)
    if poison:
        real = HostStagingRing.release

        def release(self, s):
            for t in s.traj + (s.last_obs,):
                if t.dtype.is_floating_point:
                    t.fill_(float("nan"))
            real(self, s)

        monkeypatch.setattr(HostStagingRing, "release", release)
    with _host_pool(cuda) as pool:
        ops.reset_launches()
        prl = PipelinedRL(pool, _host_agent(), seed=3, pipeline=PipelineConfig(
            queue_depth=1, lockstep=True, rho_bar=inf, c_bar=inf))
        r_pipe = prl.run(6)
    assert ops.launches["nstep_returns"] == 6
    for k in ("loss", "policy_loss", "value_loss", "entropy", "reward_sum"):
        assert r_pipe.mean_metrics[k] == r_sync.mean_metrics[k], k
    for a, b in zip(tree_leaves(rl.params), tree_leaves(prl.params)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("leg,kernel", [([], "nstep_returns"),
                                        (["--pipeline"], "vtrace_returns")],
                         ids=["sync", "pipeline"])
def test_the_trainers_host_env_legs_on_the_card(cuda, leg, kernel):
    import math

    from repro_torch.launch import train

    ops.reset_launches()
    (res,) = train.main(["--host-env", "--n-envs", "32", "--t-max", "5",
                         "--iterations", "6", "--env-spin", "200"] + leg)
    want = {k: 6 if k == kernel else 0 for k in ops.launches}
    assert dict(ops.launches) == want
    assert res.steps == 6 * 32 * 5
    assert all(math.isfinite(v) for v in res.mean_metrics.values())


@pytest.mark.cuda
def test_process_plane_on_the_card_is_the_thread_host_plane_bitwise(cuda):
    """One spawned worker acting on the card (its own CUDA context), in
    lockstep at infinite clips (K1 in the parent's learner): bitwise the
    thread host plane's run — params, metrics and the acting generator —
    and then at clips 1 through K2; the workers gone and their segments
    unlinked after close()."""
    import os

    from repro_torch.configs import PipelineConfig, get_config
    from repro_torch.core.agents import PAACAgent, PAACConfig
    from repro_torch.envs import py_bound_spec
    from repro_torch.pipeline import PipelinedRL

    inf = float("inf")
    agent = PAACAgent(get_config("paac_vector").replace(
        obs_shape=(16,), num_actions=3), PAACConfig(t_max=5))
    spec = py_bound_spec(16, obs_dim=16, spin=200, n_workers=4)
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for backend in ("thread", "process"):
            ops.reset_launches()
            with PipelinedRL(spec, agent, seed=2, pipeline=PipelineConfig(
                    queue_depth=1, lockstep=True, rho_bar=inf, c_bar=inf,
                    actor_backend=backend)) as prl:
                res = prl.run(6)
                if backend == "process":
                    procs = [w.proc for w in prl._process_plane._workers]
                    segs = prl._process_plane.segment_names()
            assert dict(ops.launches)["nstep_returns"] == 6
            runs[backend] = (res, prl)
    finally:
        torch.backends.cudnn.deterministic = False
    (r_t, p_t), (r_p, p_p) = runs["thread"], runs["process"]
    assert r_p.mean_metrics == r_t.mean_metrics
    for a, b in zip(tree_leaves(p_t.params), tree_leaves(p_p.params)):
        assert torch.equal(a, b)
    assert torch.equal(p_t._actor_keys[0][0].get_state(),
                       p_p._actor_keys[0][0].get_state())
    assert all(not p.is_alive() for p in procs)
    assert not set(segs) & set(os.listdir("/dev/shm"))
    ops.reset_launches()
    with PipelinedRL(spec.shard(2), agent, seed=2, pipeline=PipelineConfig(
            num_actors=2, queue_depth=2, actor_backend="process")) as prl:
        prl.run(8)
    assert dict(ops.launches)["vtrace_returns"] == 8
    assert sorted(prl.learned_ids) == [(a, s) for a in range(2)
                                       for s in range(4)]

"""The port on the card: hand-written kernels against their plain versions,
and the reduced qwen2 on the card against the same weights on the CPU.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. This file imports no JAX, so it also runs on a machine that has
none: from the repository root,
``PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py``.
Tolerances: fp32 1e-4; bf16 2e-2 (absolute and relative) against the
plain version in fp32 on the same bf16 inputs; logits 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
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
def test_dispatch_counts_only_kernel_launches(cuda):
    q = torch.zeros(1, 8, 4, 32, device=cuda)
    k = torch.zeros(1, 8, 2, 32, device=cuda)
    ops.reset_launches()
    ops.flash_attention(q, k, k)
    ops.decode_attention(q[:, 0].contiguous(), k, k, 3)
    ops.flash_attention(q.cpu(), k.cpu(), k.cpu())
    assert ops.launches == {"flash_attention": 1, "decode_attention": 1}
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

#!/usr/bin/env python3
"""Build variants of K3's bf16 kernel side by side and time them on one
CUDA card.

    python3 scripts/k3_variants.py [--out FILE]

Each variant is a copy of ``src/repro_torch/csrc/flash_attention_bf16.cu``
with two constants set, ``BK`` (keys a tile) and ``STAGES`` (tiles in the
cp.async ring), written to ``build/k3_variants/`` and built there with
``nvcc`` (all at once, one process each). Each is held against the plain
version on five shapes (bf16 tolerance 2e-2 + 2e-2 |ref|), then timed (CUDA
events, median of 30, L2 flushed; two rounds, every variant in turn)
beside ``scaled_dot_product_attention`` at qwen2-7b's and minicpm3-4b's
prefill shapes, at four prompts of 512, at 2048 tokens causal and
non-causal, and at deepseek-v2's MLA widths (q/k 192, v 128). Prints one
JSON object as its last line and appends it to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {  # name: (BK, STAGES); bk32s3 is the source as it stands
    "bk64s2": (64, 2), "bk64s3": (64, 3), "bk32s2": (32, 2),
    "bk32s3": (32, 3), "bk32s4": (32, 4),
}
CHECKS = (  # (B, S, H, Hkv, D, Dv, causal, window)
    (1, 512, 28, 4, 128, 128, True, 0), (1, 77, 28, 4, 128, 128, True, 0),
    (1, 300, 16, 16, 192, 128, True, 90), (1, 333, 16, 4, 112, 112, False, 0),
    (2, 200, 8, 2, 48, 32, True, 64))
TIMED = (  # (label, B, S, H, Hkv, D, Dv, causal)
    ("qwen2-7b prefill 512", 1, 512, 28, 4, 128, 128, True),
    ("MLA prefill 512", 1, 512, 40, 40, 96, 64, True),
    ("qwen2-7b 4 x 512", 4, 512, 28, 4, 128, 128, True),
    ("qwen2-7b 2048 causal", 1, 2048, 28, 4, 128, 128, True),
    ("qwen2-7b 2048 full", 1, 2048, 28, 4, 128, 128, False),
    ("192/128 prefill 512", 1, 512, 16, 16, 192, 128, True))


def variant_source(text: str, bk: int, stages: int) -> str:
    for name, value in (("BK", bk), ("STAGES", stages)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"flash_attention_bf16.cu: no single {name}")
    return text


def build(build_mod, out: Path):
    """{name: ctypes function} of every variant; prints the registers and
    spills of each one's <128, 128> instantiation. Raises if one fails."""
    out.mkdir(parents=True, exist_ok=True)
    text = (build_mod.CSRC / "flash_attention_bf16.cu").read_text()
    t0 = time.perf_counter()
    procs = {}
    for name, (bk, stages) in VARIANTS.items():
        src = out / f"{name}.cu"
        src.write_text(variant_source(text, bk, stages))
        procs[name] = subprocess.Popen(
            [build_mod.nvcc_path(), *build_mod.NVCC_FLAGS,
             f"-I{build_mod.CSRC}", "-o", str(out / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{text[-3000:]}")
        lines = text.splitlines()
        info = [" ".join(x.strip() for x in lines[i + 2:i + 4])
                for i, ln in enumerate(lines)
                if "Compiling entry" in ln and "ILi128ELi128E" in ln]
        print(f"{name}: built by {time.perf_counter() - t0:.1f} s; <128, 128>: "
              f"{info}", flush=True)
        fn = ctypes.CDLL(str(out / f"{name}.so")).flash_attention_bf16_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="append the JSON line here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import _build, ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    fns = build(_build, ROOT / "build" / "k3_variants")
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    def call(fn, q, k, v, causal, window=0):
        B, Sq, H, D = q.shape
        _, Sk, Hkv, Dv = v.shape
        o = torch.empty(B, Sq, H, Dv, dtype=q.dtype, device=q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
                B, Sq, Sk, H, Hkv, D, Dv, int(causal), window, D ** -0.5,
                torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"launch failed: CUDA error {rc}")
        return o

    res = {"card": card, "errors": {}, "ms": {}}
    for name, fn in fns.items():
        worst = 0.0
        for B, S, H, Hkv, D, Dv, causal, window in CHECKS:
            q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, Dv)
            worst = max(worst, cs.within(torch, call(fn, q, k, v, causal, window),
                                         ref.flash_attention_ref(
                                             q.float(), k.float(), v.float(),
                                             causal=causal, window=window),
                                         "bfloat16"))
        res["errors"][name] = worst
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    for label, B, S, H, Hkv, D, Dv, causal in TIMED:
        q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, Dv)
        row = {}
        for _ in range(2):
            for name, fn in fns.items():
                row.setdefault(name, []).append(cs.time_ms(
                    torch, lambda: call(fn, q, k, v, causal), flush))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        row["sdpa"] = [cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), flush)]
        res["ms"][label] = row
        print(label, {n: [round(x, 4) for x in t] for n, t in row.items()},
              flush=True)
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

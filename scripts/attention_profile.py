#!/usr/bin/env python3
"""Time the port's prefill and decode attention (K3, K4) and profile the
serving work they run in, for one copy of ``repro_torch``, on one CUDA card.

    python3 scripts/attention_profile.py [--src DIR] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured (by
default this checkout's); the measuring code is ``chip_smoke.py``'s, from
this checkout, so two versions of the kernels are measured by the same code.
Compare two versions on the same card, one after the other, in turns (A,
B, B, A): a card may be set below its full power limit, and two machines
hold two cards. In bf16, with CUDA-event times (median of 30, L2 flushed):

- K3 at qwen2-7b's prefill (B=1 S=512 H=28 Hkv=4 D=128, causal) and at
  minicpm3-4b's MLA prefill (B=1 S=512 H=40 D=96 Dv=64, causal), each
  beside ``scaled_dot_product_attention`` on the same inputs;
- K4 at W=8 S=1024 H=28 Hkv=4 D=128 (per-row pos 0 ... 1023) and at
  qwen2-7b's serving decode step (W=4 S=544, pos 256-264), beside SDPA;
- qwen2-7b at full size (random weights from seed 0): the decode step of
  ``chip_smoke.profile_decode`` (4 rows at pos 256-264) with K4's share of
  its device-busy time, and a 512-token prefill through
  ``DecodeEngine.admit`` with K3's share;
- minicpm3-4b at full size: the same 512-token prefill with K3's share.

Prints one JSON object as its last line and appends it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kernel_rows(torch, np, F, cs, ref, fa, da):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    rows = {}
    for label, (B, S, H, Hkv, D, Dv) in (("K3 qwen2-7b", (1, 512, 28, 4, 128, 128)),
                                         ("K3 MLA", (1, 512, 40, 40, 96, 64))):
        q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, Dv)
        out = fa.flash_attention_cuda(q, k, v)
        err = cs.within(torch, out, ref.flash_attention_ref(
            q.float(), k.float(), v.float()), "bfloat16")
        ms = cs.time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v), flush)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
        flops = 2 * (D + Dv) * cs.flash_pairs(np, S, S, True, 0) * H * B
        rows[label] = {"ms": ms, "sdpa_ms": lib, "max_abs_err": err,
                       "bound_ms": cs.bound(nbytes, flops, "bfloat16")[0]}
    for label, (W, S, pos) in (
            ("K4 W=8 S=1024", (8, 1024, [0, 1, 63, 64, 300, 777, 1000, 1023])),
            ("K4 serving step", (4, 544, [256, 259, 262, 264]))):
        H, Hkv, D = 28, 4, 128
        q, kc, vc = randn(W, H, D), randn(W, S, Hkv, D), randn(W, S, Hkv, D)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = da.decode_attention_cuda(q, kc, vc, p)
        err = cs.within(torch, out, ref.decode_attention_ref(
            q.float(), kc.float(), vc.float(), p), "bfloat16")
        ms = cs.time_ms(torch, lambda: da.decode_attention_cuda(q, kc, vc, p), flush)
        mask = (torch.arange(S, device=dev)[None, :] <= p[:, None])[:, None, None, :]
        q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        lib = cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True), flush)
        keys = sum(min(x + 1, S) for x in pos)
        nbytes = 2 * (q.numel() + out.numel() + 2 * keys * Hkv * D) + 4 * W
        rows[label] = {"ms": ms, "sdpa_ms": lib, "max_abs_err": err,
                       "bound_ms": cs.bound(nbytes, 4 * H * D * keys,
                                            "bfloat16")[0]}
    del flush
    return rows


def serving_rows(torch, np, cs, configs, models, serving):
    rows = {}
    for cell in cs.SERVING_CELLS[:2]:  # qwen2-7b, minicpm3-4b
        arch = cell["arch"]
        cfg = configs.get_config(arch).replace(**cell["change"])
        params = models.init_policy(
            cfg, generator=torch.Generator(device="cuda").manual_seed(cs.SEED),
            device="cuda")
        slots, max_len = 4, max(cell["prompt_lens"]) + 32
        row = {}
        if cell["decode"] == "decode_attention":
            wall, busy, _, _, by_name = cs.profile_decode(
                torch, np, serving, cfg, params, slots, max_len)
            k_ms, k_n = cs.kernel_time(by_name, "decode_attention")
            row.update(decode_wall_ms=wall, decode_busy_ms=busy,
                       decode_k4_ms=k_ms, decode_k4_launches=k_n)
        wall, busy, by_name = cs.profile_prefill(
            torch, np, serving, cfg, params, slots, max_len,
            prompt_len=max(cell["prompt_lens"]))
        k_ms, k_n = cs.kernel_time(by_name, "flash_attention")
        row.update(prefill_wall_ms=wall, prefill_busy_ms=busy,
                   prefill_k3_ms=k_ms, prefill_k3_launches=k_n)
        rows[arch] = row
        del params
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is measured")
    ap.add_argument("--label", default="", help="names the run in the output")
    ap.add_argument("--out", default="", help="append the JSON line here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("attention_profile: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch import configs, models, serving
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"measuring {Path(fa.__file__).resolve()} on {card}", flush=True)
    res = {"label": args.label, "card": card,
           "kernels": kernel_rows(torch, np, F, cs, ref, fa, da),
           "serving": serving_rows(torch, np, cs, configs, models, serving)}
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

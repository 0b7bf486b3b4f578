#!/usr/bin/env python3
"""Time the port's absorbed MLA decode (K5) and Mamba2 SSD scan (K6) and
profile the serving work they run in, for one copy of ``repro_torch``, on
one CUDA card.

    python3 scripts/latent_profile.py [--src DIR] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured (by
default this checkout's); the measuring code is ``chip_smoke.py``'s, from
this checkout, so two versions of the kernels are measured by the same code,
as ``scripts/attention_profile.py`` does for K3 and K4. Compare two versions
on the same card, one after the other, in turns (A, B, B, A). In bf16, with
CUDA-event times (median of 30, L2 flushed, ``chip_smoke.time_ms``) and
device times from a torch.profiler window of 20 calls (each CUDA kernel of
the call and their sum, L2 flushed):

- K5 at minicpm3-4b's decode shape (W=4 S=544 H=40 R=256 Rr=32, per-row pos
  127, 250, 399, 543) beside ``scaled_dot_product_attention`` on (q_lat ||
  q_rope) against (c || kr) with v = c and the per-row bound as a mask;
- K6 at mamba2-370m's prefill shape (B=1 S=512 H=32 P=64 N=128, chunk 128);
- minicpm3-4b at full size with ``mla_absorb=True`` (random weights from
  seed 0): the decode step of ``chip_smoke.profile_decode`` (4 rows at pos
  256-264) with K5's share of its device-busy time;
- mamba2-370m at full size: a 512-token prefill through
  ``DecodeEngine.admit`` with K6's share.

Prints one JSON object as its last line and appends it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def device_ms(torch, cs, fn, flush, kernel: str, n: int = 20):
    """Device time of one call of ``fn`` from a torch.profiler window of
    ``n`` calls, each after an L2 flush: (ms a call, launches a call,
    {CUDA kernel: ms a call}) over ``kernel``'s CUDA kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    _, by_name = cs.device_window(prof, n)
    ms, launches = cs.kernel_time(by_name, kernel)
    parts = {}
    for short in cs.PROFILE_NAMES[kernel]:
        k_ms, k_n = cs.kernel_time(
            {name: row for name, row in by_name.items() if short in name},
            kernel)
        if k_n:
            parts[short] = k_ms
    return ms, launches, parts


def kernel_rows(torch, F, cs, ref, mk, sk):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    rows = {}
    W, S, H, R, Rr = 4, 544, 40, 256, 32
    pos = [127, 250, 399, 543]
    scale = 1.0 / math.sqrt(64 + 32)
    ql, qr, c, kr = randn(W, H, R), randn(W, H, Rr), randn(W, S, R), randn(W, S, Rr)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    out = mk.mla_decode_attention_cuda(ql, qr, c, kr, p, scale)
    err = cs.within(torch, out, ref.mla_decode_attention_ref(
        ql.float(), qr.float(), c.float(), kr.float(), p, scale), "bfloat16")
    ms = cs.time_ms(torch, lambda: mk.mla_decode_attention_cuda(
        ql, qr, c, kr, p, scale), flush)
    qcat = torch.cat([ql, qr], dim=-1)[:, :, None]
    kcat = torch.cat([c, kr], dim=-1)[:, None]
    mask = (torch.arange(S, device=dev)[None, :] <= p[:, None])[:, None, None, :]
    lib = cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
        qcat, kcat, c[:, None], attn_mask=mask, scale=scale, enable_gqa=True),
        flush)
    keys = sum(min(x + 1, S) for x in pos)
    nbytes = 2 * (ql.numel() + qr.numel() + out.numel() + keys * (R + Rr)) + 4 * W
    flops = 2 * H * keys * (R + Rr) + 2 * H * keys * R
    dev_ms, n, parts = device_ms(torch, cs, lambda: mk.mla_decode_attention_cuda(
        ql, qr, c, kr, p, scale), flush, "mla_decode_attention")
    rows["K5 minicpm3-4b decode"] = {
        "ms": ms, "device_ms": dev_ms, "device_launches": n,
        "device_parts": parts, "sdpa_ms": lib, "max_abs_err": err,
        "bound_ms": cs.bound(nbytes, flops, "bfloat16")[0]}

    B, S, H, P, N, Q = 1, 512, 32, 64, 128, 128
    A = torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev))
    Dh = torch.ones(H, device=dev)
    x = randn(B, S, H, P)
    dts = F.softplus(randn(B, S, H, dtype=torch.float32) - 2.0)
    Bm, Cm = randn(B, S, N), randn(B, S, N)
    y, st = sk.ssd_scan_cuda(x, dts, A, Bm, Cm, Dh, chunk=Q)
    y_ref, st_ref = ref.ssd_scan_ref(x.float(), dts, A, Bm.float(), Cm.float(),
                                     Dh, chunk=Q)
    err = max(cs.within_rel(torch, y, y_ref, cs.BF16_TOL, cs.BF16_TOL, "K6 y"),
              cs.within_rel(torch, st, st_ref, cs.SSD_TOL, cs.SSD_TOL,
                            "K6 state"))
    ms = cs.time_ms(torch, lambda: sk.ssd_scan_cuda(x, dts, A, Bm, Cm, Dh,
                                                    chunk=Q), flush)
    nc, tri = S // Q, Q * (Q + 1) // 2
    flops = B * H * (nc * (2 * N * tri + 2 * P * tri + 2 * Q * P * N)
                     + (nc - 1) * 2 * Q * N * P)
    nbytes = (2 * (2 * x.numel() + Bm.numel() + Cm.numel())
              + 4 * (dts.numel() + 2 * H + st.numel()))
    dev_ms, n, parts = device_ms(torch, cs, lambda: sk.ssd_scan_cuda(
        x, dts, A, Bm, Cm, Dh, chunk=Q), flush, "ssd_scan")
    rows["K6 mamba2-370m prefill"] = {
        "ms": ms, "device_ms": dev_ms, "device_launches": n,
        "device_parts": parts, "max_abs_err": err,
        "bound_ms": cs.bound(nbytes, flops, "bfloat16")[0]}
    del flush
    return rows


def serving_rows(torch, np, cs, configs, models, serving):
    rows = {}
    for cell in cs.SERVING_CELLS[1:3]:  # minicpm3-4b, mamba2-370m
        arch = cell["arch"]
        cfg = configs.get_config(arch).replace(**cell["change"])
        params = models.init_policy(
            cfg, generator=torch.Generator(device="cuda").manual_seed(cs.SEED),
            device="cuda")
        slots, max_len = 4, max(cell["prompt_lens"]) + 32
        row = {}
        if cell["decode"] == "mla_decode_attention":
            wall, busy, _, _, by_name = cs.profile_decode(
                torch, np, serving, cfg, params, slots, max_len)
            k_ms, k_n = cs.kernel_time(by_name, "mla_decode_attention")
            row.update(decode_wall_ms=wall, decode_busy_ms=busy,
                       decode_k5_ms=k_ms, decode_k5_launches=k_n)
        else:
            wall, busy, by_name = cs.profile_prefill(
                torch, np, serving, cfg, params, slots, max_len,
                prompt_len=max(cell["prompt_lens"]))
            k_ms, k_n = cs.kernel_time(by_name, "ssd_scan")
            row.update(prefill_wall_ms=wall, prefill_busy_ms=busy,
                       prefill_k6_ms=k_ms, prefill_k6_launches=k_n)
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
        print("latent_profile: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch import configs, models, serving
    from repro_torch.kernels import mla_decode as mk
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"measuring {Path(mk.__file__).resolve()} on {card}", flush=True)
    res = {"label": args.label, "card": card,
           "kernels": kernel_rows(torch, F, cs, ref, mk, sk),
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

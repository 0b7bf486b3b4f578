#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

It builds the port's kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
into ``build/repro_torch/``) and drives the serving path:

1. card     — the card's name and power limit as nvidia-smi gives them,
              then the build of every kernel;
2. kernels  — each hand-written kernel against its plain PyTorch version on
              the card, at the serving path's shapes, in fp32 (atol 1e-4)
              and bf16 (|err| <= 2e-2 + 2e-2 |ref| against the plain
              version in fp32 on the same bf16 inputs), with CUDA-event
              times (median of 30, L2 flushed) of the kernel, the plain
              version and scaled_dot_product_attention (a yardstick only);
3. model    — reduced qwen2-7b in fp32, one set of weights on the CPU
              (plain versions) and on the card (kernels): prefill and
              decode logits must agree within 1e-4;
4. serving  — qwen2-7b at full width and depth (28 layers, d_model 3584,
              bf16, random weights from a seed): 8 requests over 4 slots,
              prompts of 128 to 512 tokens, 16 to 32 new tokens each, burst
              arrival, through the port's continuous-batching entry point;
              every request must finish with tokens in [0, vocab), K3 must
              launch 28 times per admitted request and K4 28 times per
              decode step, and one request rerun alone on a fresh engine
              must give bitwise the same tokens; a torch.profiler window
              of 8 decode steps gives the device-busy share of a step;
              then the lockstep demo, whose decode runs K4 with a scalar
              position.

The line before the last is a JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
when any phase fails, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; fp32 off the tensor cores
FP32_ATOL = 1e-4
BF16_TOL = 2e-2
MODEL_ATOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fn, flush, iters: int = 30) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` launches, each after
    an L2 flush (the serving path meets each layer's cache cold)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, flops: float, dtype: str):
    """(least time in ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_pairs(np, Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible."""
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return int(mask.sum())


def tolerance(dtype: str) -> str:
    return (f"atol {FP32_ATOL}" if dtype == "float32" else
            f"atol {BF16_TOL} + rtol {BF16_TOL}")


def within(torch, out, ref, dtype: str) -> float:
    err = (out.float() - ref).abs()
    if dtype == "float32":
        ok = bool((err <= FP32_ATOL).all())
    else:
        ok = bool((err <= BF16_TOL + BF16_TOL * ref.abs()).all())
    check(bool(torch.isfinite(out.float()).all()), "non-finite kernel output")
    check(ok, f"kernel disagrees with its plain version: max err {err.max().item():.3g}")
    return err.max().item()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card(torch, build):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = out.splitlines()[0]
    print(card, flush=True)
    say("card", f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
        regs = [ln.strip() for ln in build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        say("card", f"built {name}: " + " | ".join(regs[:4]))
    say("card", f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    return card


def phase_kernels(torch, np, F, ref, fa, da):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(getattr(torch, dtype))

    rows = {}
    B, H, Hkv, D = 1, 28, 4, 128
    for dtype in ("float32", "bfloat16"):
        for S, window in ((512, 0), (77, 0), (512, 100)):
            q = randn(B, S, H, D, dtype=dtype)
            k = randn(B, S, Hkv, D, dtype=dtype)
            v = randn(B, S, Hkv, D, dtype=dtype)
            out = fa.flash_attention_cuda(q, k, v, causal=True, window=window)
            plain = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                            causal=True, window=window)
            err = within(torch, out, plain, dtype)
            say("kernels", f"K3 flash_attention {dtype} B={B} S={S} H={H} "
                f"Hkv={Hkv} D={D} causal window={window}: max_abs_err {err:.3g} "
                f"({tolerance(dtype)})")
            row = rows.setdefault("flash_attention", {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if dtype == "bfloat16" and S == 512 and window == 0:
                ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v), flush)
                plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v), flush)
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), flush)
                nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
                flops = 4 * D * flash_pairs(np, S, S, True, 0) * H * B
                b_ms, b_by = bound(nbytes, flops, dtype)
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           shape=f"bf16 B={B} S={S} H={H} Hkv={Hkv} D={D} causal")
                say("kernels", f"K3 timed ({row['shape']}): kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by})")

    S = 1024
    for dtype in ("float32", "bfloat16"):
        for W, S_, pos in ((8, S, [0, 1, 63, 64, 300, 777, 1000, S - 1]),
                           (8, S, 600), (4, 544, [127, 250, 399, 543])):
            q = randn(W, H, D, dtype=dtype)
            kc = randn(W, S_, Hkv, D, dtype=dtype)
            vc = randn(W, S_, Hkv, D, dtype=dtype)
            p = (torch.tensor(pos, dtype=torch.int32, device=dev)
                 if isinstance(pos, list) else pos)
            out = da.decode_attention_cuda(q, kc, vc, p)
            plain = ref.decode_attention_ref(q.float(), kc.float(), vc.float(), p)
            err = within(torch, out, plain, dtype)
            say("kernels", f"K4 decode_attention {dtype} W={W} S={S_} H={H} "
                f"Hkv={Hkv} D={D} pos={pos}: max_abs_err {err:.3g} "
                f"({tolerance(dtype)})")
            row = rows.setdefault("decode_attention", {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if dtype == "bfloat16" and isinstance(pos, list) and S_ == S:
                ms = time_ms(torch, lambda: da.decode_attention_cuda(q, kc, vc, p), flush)
                plain_ms = time_ms(torch, lambda: ref.decode_attention_ref(q, kc, vc, p), flush)
                mask = (torch.arange(S_, device=dev)[None, :] <= p[:, None])[:, None, None, :]
                q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4, kt, vt, attn_mask=mask, enable_gqa=True), flush)
                keys = sum(min(x + 1, S_) for x in pos)
                nbytes = 2 * (q.numel() + out.numel() + 2 * keys * Hkv * D) + 4 * W
                flops = 4 * H * D * keys
                b_ms, b_by = bound(nbytes, flops, dtype)
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           shape=f"bf16 W={W} S={S_} H={H} Hkv={Hkv} D={D} pos={pos}")
                say("kernels", f"K4 timed ({row['shape']}): kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by})")
    del flush
    return rows


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_model(torch, np, configs, models):
    """Reduced qwen2-7b, fp32: CPU (plain versions) against the card."""
    cfg = configs.get_config("qwen2-7b").reduced()
    cpu = models.init_policy(cfg, generator=torch.Generator().manual_seed(SEED),
                             device="cpu")
    gpu = _tree_to(cpu, "cuda")
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 37)))
    worst = 0.0
    lc, _, cache_c = models.policy_prefill(cpu, cfg, toks, max_len=48)
    lg, _, cache_g = models.policy_prefill(gpu, cfg, toks.cuda(), max_len=48)
    worst = max(worst, (lc - lg.cpu()).abs().max().item())
    steps = [torch.tensor([37, 40], dtype=torch.int32), 41, 42,
             torch.tensor([43, 38], dtype=torch.int32)]
    for pos in steps:
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
        pos_g = pos.cuda() if isinstance(pos, torch.Tensor) else pos
        lc, _, cache_c = models.policy_decode(cpu, cfg, cache_c, tok, pos)
        lg, _, cache_g = models.policy_decode(gpu, cfg, cache_g, tok.cuda(), pos_g)
        worst = max(worst, (lc - lg.cpu()).abs().max().item())
    check(worst <= MODEL_ATOL, f"reduced qwen2 logits: card vs CPU {worst:.3g}")
    say("model", f"reduced qwen2-7b fp32 (L={cfg.num_layers} d={cfg.d_model} "
        f"H={cfg.num_heads} Hkv={cfg.num_kv_heads} D={cfg.head_dim}): prefill "
        f"+ 4 decode steps (per-row and scalar pos), card vs CPU max |dlogit| "
        f"{worst:.3g} <= {MODEL_ATOL}")


def phase_serving(torch, np, configs, models, ops, serve, serving, card):
    from repro_torch.pipeline.queue import TrajectoryQueue

    cfg = configs.get_config("qwen2-7b")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.param_dtype) == (28, 3584, 28, 4, 128, "bfloat16"),
          f"not the full qwen2-7b config: {cfg}")
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = models.init_policy(
        cfg, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    say("serving", f"qwen2-7b full size: {n_params / 1e9:.2f} B parameters "
        f"(bf16) initialised on the card from seed {SEED} in "
        f"{time.perf_counter() - t0:.1f} s")

    slots, prompt_lens, gen_range = 4, (128, 200, 333, 512), (16, 32)
    max_len = max(prompt_lens) + gen_range[1]
    kw = dict(slots=slots, max_len=max_len, prompt_lens=prompt_lens,
              gen_range=gen_range, rate_hz=0.0, device="cuda")
    serve.serve_continuous(cfg, params, requests=2, seed=SEED + 1, **kw)  # warm-up

    ops.reset_launches()
    res = serve.serve_continuous(cfg, params, requests=8, seed=SEED, **kw)
    counts = dict(ops.launches)
    reqs = res["requests"]
    check(len(reqs) == 8, f"{len(reqs)} of 8 requests came back")
    for r in reqs:
        check(r.status == "done", f"request {r.rid} {r.status}: {r.error}")
        check(len(r.tokens) == r.max_new_tokens,
              f"request {r.rid}: {len(r.tokens)} of {r.max_new_tokens} tokens")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()),
              f"request {r.rid}: token out of [0, {cfg.vocab_size})")
    check(res["admitted"] == 8, f"{res['admitted']} requests admitted")
    check(counts["flash_attention"] == L * res["admitted"],
          f"K3 launched {counts['flash_attention']} times for "
          f"{res['admitted']} prefills of {L} layers")
    check(counts["decode_attention"] == L * res["steps"],
          f"K4 launched {counts['decode_attention']} times for "
          f"{res['steps']} decode steps of {L} layers")
    say("serving", f"continuous: 8/8 requests done, {res['tokens']} tokens, "
        f"{res['steps']} decode steps, launches K3 {counts['flash_attention']}"
        f" (= {L} x {res['admitted']} prefills) K4 {counts['decode_attention']}"
        f" (= {L} x {res['steps']} steps)")
    say("serving", f"qwen2-7b bf16, {slots} slots, burst of 8: "
        f"{res['tok_s']:.1f} tok/s aggregate, latency p50 {res['p50_ms']:.1f} ms "
        f"p99 {res['p99_ms']:.1f} ms, wall {res['wall_s']:.3f} s ({card})")

    probe = max(reqs, key=lambda r: (r.t_admit, r.rid))  # joined mid-flight
    solo = serving.Request(rid=probe.rid, prompt=probe.prompt.copy(),
                           max_new_tokens=probe.max_new_tokens, seed=probe.seed)
    q = TrajectoryQueue(depth=2)
    q.put(solo)
    q.producer_done()
    engine = serving.DecodeEngine(cfg, params, max_slots=slots,
                                  max_len=max_len, device="cuda")
    serving.Scheduler(engine, q, continuous=False).run()
    check(solo.status == "done" and np.array_equal(solo.tokens, probe.tokens),
          f"request {probe.rid}: continuous {probe.tokens.tolist()} != solo "
          f"{None if solo.tokens is None else solo.tokens.tolist()}")
    say("serving", f"request {probe.rid} (prompt {len(probe.prompt)}, "
        f"{probe.max_new_tokens} tokens) rerun solo on a fresh {slots}-slot "
        "engine: bitwise equal")
    del engine

    wall_ms, busy_ms, top = profile_decode(torch, np, serving, cfg, params,
                                           slots, max_len)
    busy = (f"device busy {busy_ms:.2f} ms a step ({100 * busy_ms / wall_ms:.0f}%"
            " of the unprofiled step)" if busy_ms > 0 else
            "device time not measured (the profiler saw no device activity)")
    say("serving", f"decode step, {slots} rows at pos 256-264, torch.profiler "
        f"window of 8 steps: wall {wall_ms:.2f} ms a step without the "
        f"profiler, {busy}; top kernels (ms a step, launches a step): "
        + "; ".join(f"{k} {ms:.3f} x{n}" for k, ms, n in top))

    _, prompt_gen, decode_gen = serve.demo_generators(SEED, "cuda")
    ops.reset_launches()
    lock = serve.run_lockstep(cfg, params, batch=4, prompt_len=128, gen=8,
                              prompt_gen=prompt_gen, decode_gen=decode_gen,
                              device="cuda")
    lock_counts = dict(ops.launches)
    check(lock["logits_finite"], "lockstep prefill logits not finite")
    check(lock["tokens"].shape == (4, 9), f"lockstep tokens {lock['tokens'].shape}")
    check(bool(((lock["tokens"] >= 0) & (lock["tokens"] < cfg.vocab_size)).all()),
          "lockstep token out of range")
    check(lock_counts == {"flash_attention": L, "decode_attention": 8 * L},
          f"lockstep launches {lock_counts}")
    say("serving", f"lockstep demo (scalar pos): batch 4, prompt 128, 8 steps, "
        f"launches {lock_counts}; prefill {lock['prefill_s'] * 1e3:.1f} ms, "
        f"decode {lock['decode_s'] * 1e3:.1f} ms")
    return counts


def profile_decode(torch, np, serving, cfg, params, slots, max_len,
                   steps: int = 8):
    """Decode step time with and without torch.profiler, over a steady
    window of ``steps`` steps with every slot leased: (wall ms a step,
    device-busy ms a step, top kernels by device time)."""
    from torch.profiler import ProfilerActivity, profile

    engine = serving.DecodeEngine(cfg, params, max_slots=slots,
                                  max_len=max_len, device="cuda")
    rng = np.random.default_rng(SEED)
    for slot in range(slots):
        engine.admit(slot, rng.integers(0, cfg.vocab_size, 256), seed=slot)
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in avgs) / steps / 1e3
    top = sorted(avgs, key=lambda e: e.self_device_time_total, reverse=True)
    top = [(e.key[:60], e.self_device_time_total / steps / 1e3, e.count // steps)
           for e in top[:5] if e.self_device_time_total > 0]
    return wall_ms, busy_ms, top


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


KERNELS = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:113"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:103"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import configs, models, serving
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_card(torch, _build)
    rows = phase_kernels(torch, np, F, ref, fa, da)
    phase_model(torch, np, configs, models)
    counts = phase_serving(torch, np, configs, models, ops, serve, serving, card)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"]})
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving launcher of the port: lockstep batch demo, or continuous batching.

Two modes, as in ``repro.launch.serve``:

* **default (lockstep batch)** — batched prefill for ``--batch``
  identical-length prompts, then a decode loop emitting one token per
  actor per step through ``serve_step``, every row at the same (scalar)
  position.
* **``--continuous``** — the serving plane: an open-loop traffic source
  feeds a bounded admission queue; the ``Scheduler`` leases cache slots and
  requests join/leave the decode batch mid-flight, each row at its own
  position. Reports aggregate tokens/s and p50/p99 request latency.

``--arch`` takes every registered token model: qwen2-7b, glm4-9b and
deepseek-coder-33b (GQA: K3 prefill, K4 decode), dbrx-132b (GQA + MoE:
the same kernels), minicpm3-4b and deepseek-v2-236b (MLA, the latter with
MoE: K3 prefill with q/k wider than v; the config's naive decode, or K5
when a caller serves ``cfg.replace(mla_absorb=True)``, as
``chip_smoke.py`` does), mamba2-370m (SSM: K6 prefill, recurrent
decode) and zamba2-7b (hybrid: K6 prefill in its 81 Mamba2 layers, K3
prefill and K4 decode in the 13 applications of its shared attention
block); for the last two a prompt longer than one 128-token chunk must be
a whole number of chunks. A full-depth MoE model does not fit one card;
the CLI, like the reference's, has no depth flag. Runs on the card
(``--device cuda``, the default) unless ``--device cpu`` is given; without
a CUDA device the default raises.

``--trace`` records phase spans (lockstep: ``prefill``/``decode``;
continuous: ``admit``/``prefill``/``decode``/``evict``) and writes a
Chrome trace-event JSON at exit, also when the run fails.
``--metrics-jsonl`` streams the heartbeat every 0.25 s; in continuous
mode it carries the ``serve_queue_depth`` and ``serve_active_slots``
gauges. Neither adds a host sync to the decode step: the spans record
host time around the dispatch, and the heartbeat reads host counters on
its own thread.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --batch 8 --prompt-len 64 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        --continuous --requests 8 --slots 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --continuous --requests 8 --slots 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b \\
        --reduced --device cpu --continuous --requests 16 --slots 4 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --continuous --trace serve_trace.json --metrics-jsonl serve.jsonl
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_serve_step
from repro_torch.models import init_policy, policy_prefill
from repro_torch.telemetry import SpanEmitter, Telemetry
from repro_torch.utils import get_logger
from repro_torch.utils.sampling import seeded_generators

log = get_logger("serve")

_PREFILL, _DECODE = 0, 1  # the lockstep demo's span categories


def demo_generators(seed: int, device):
    """Three independent generators on ``device`` — parameters, prompts,
    decode sampling — from one root seed."""
    return seeded_generators(seed, 3, device)


def percentile_ms(xs, q: float) -> float:
    """Latency percentile in milliseconds (empty-safe for error-only runs)."""
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), q) * 1e3)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_lockstep(cfg, params, *, batch: int, prompt_len: int, gen: int,
                 prompt_gen, decode_gen, device, telemetry=None) -> dict:
    """Batched prefill of ``batch`` random prompts, then ``gen`` decode
    steps at the shared positions prompt_len, prompt_len + 1, ...
    Returns the tokens (batch, gen + 1) and the phase times. With a
    ``telemetry`` hub each phase is a span on its ``serve`` track."""
    dev = resolve_device(device)
    cats = ("prefill", "decode")
    em = (telemetry.emitter("serve", categories=cats)
          if telemetry is not None else SpanEmitter("serve", categories=cats))
    B, S = batch, prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=prompt_gen,
                            device=dev)
    t0 = time.perf_counter()
    em.begin(_PREFILL)
    try:
        logits, _values, cache = policy_prefill(params, cfg, prompts,
                                                max_len=S + gen)
        token = logits[:, -1].argmax(dim=-1)[:, None]
        _sync(dev)
    finally:
        em.end()
    t_prefill = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits[:, -1]).all())
    log.info("prefill %.3fs (%.0f tok/s)", t_prefill, B * S / t_prefill)

    serve_step = build_serve_step(cfg)
    toks = [token]
    t0 = time.perf_counter()
    for i in range(gen):
        em.begin(_DECODE)  # the step's dispatch, not its execution
        try:
            token, _value, cache = serve_step(params, cache, token, S + i,
                                              decode_gen)
        finally:
            em.end()
        toks.append(token)
    out = torch.cat(toks, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    log.info("decode %d tokens x %d actors: %.3fs (%.0f tok/s)",
             gen, B, dt, gen * B / dt)
    log.info("sample actor 0 tokens: %s", out[0, :16].tolist())
    return {"tokens": out, "prefill_s": t_prefill, "decode_s": dt,
            "logits_finite": finite}


def serve_continuous(cfg, params, *, requests: int, slots: int, max_len: int,
                     prompt_lens: Sequence[int], gen_range: Tuple[int, int],
                     rate_hz: float, seed: int, device,
                     telemetry=None) -> dict:
    """Serve ``requests`` open-loop requests through the continuous
    scheduler. Returns the requests, the decode step count and the
    aggregate numbers. With a ``telemetry`` hub the admission queue and
    the scheduler record onto it (tracks, gauges, the ``steps`` counter)."""
    from repro_torch.pipeline.queue import TrajectoryQueue
    from repro_torch.serving import DecodeEngine, OpenLoopTraffic, Scheduler

    engine = DecodeEngine(cfg, params, max_slots=slots, max_len=max_len,
                          device=device)
    queue = TrajectoryQueue(depth=max(2, 2 * slots), telemetry=telemetry)
    sched = Scheduler(engine, queue, continuous=True, telemetry=telemetry)
    traffic = OpenLoopTraffic(
        queue, requests, seed=seed, rate_hz=rate_hz, prompt_lens=prompt_lens,
        gen_range=gen_range, vocab=cfg.vocab_size)

    t0 = time.perf_counter()
    traffic.start()
    try:
        done = sched.run()
    finally:
        queue.close()
        traffic.join()
    wall = time.perf_counter() - t0

    ok = [r for r in done if r.status == "done"]
    lat = [r.latency_s for r in ok]
    total = sum(r.n_generated for r in ok)
    res = {"requests": done, "steps": sched.steps, "admitted":
           len(sched.admit_order), "wall_s": wall, "tokens": total,
           "tok_s": total / wall, "p50_ms": percentile_ms(lat, 50),
           "p99_ms": percentile_ms(lat, 99)}
    log.info("continuous: %d/%d requests done, %d tokens in %.3fs "
             "(%.1f tok/s aggregate, %d decode steps)",
             len(ok), len(done), total, wall, res["tok_s"], sched.steps)
    log.info("latency p50 %.1f ms  p99 %.1f ms", res["p50_ms"], res["p99_ms"])
    for r in done:
        if r.status != "done":
            log.warning("request %d %s: %s", r.rid, r.status, r.error)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; raises "
                    "without a CUDA device unless 'cpu' is given)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching service loop instead of the "
                    "lockstep batch demo")
    ap.add_argument("--requests", type=int, default=16,
                    help="[--continuous] total requests the traffic source "
                    "emits")
    ap.add_argument("--slots", type=int, default=4,
                    help="[--continuous] decode-batch width / cache slots")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="[--continuous] open-loop arrival rate in Hz "
                    "(0 = burst)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace-event JSON of serving spans "
                    "here (open in Perfetto)")
    ap.add_argument("--metrics-jsonl", default="",
                    help="append a JSONL metrics heartbeat here")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    hub = Telemetry()
    if args.metrics_jsonl:
        hub.heartbeat_start(args.metrics_jsonl, interval=0.25)
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        params_gen, prompt_gen, decode_gen = demo_generators(args.seed,
                                                             device)
        params = init_policy(cfg, generator=params_gen, device=device)
        if args.continuous:
            lo = max(1, args.prompt_len // 2)
            return serve_continuous(
                cfg, params, requests=args.requests, slots=args.slots,
                max_len=args.prompt_len + args.gen,
                prompt_lens=(lo, args.prompt_len),
                gen_range=(max(1, args.gen // 2), args.gen),
                rate_hz=args.rate, seed=args.seed, device=device,
                telemetry=hub)
        return run_lockstep(cfg, params, batch=args.batch,
                            prompt_len=args.prompt_len, gen=args.gen,
                            prompt_gen=prompt_gen, decode_gen=decode_gen,
                            device=device, telemetry=hub)
    finally:
        hub.heartbeat_stop()
        if args.trace:
            hub.write_trace(args.trace)


if __name__ == "__main__":
    main()

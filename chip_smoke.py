#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

It builds the port's kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
into ``build/repro_torch/``) and drives the training path and the serving
paths:

1. card     — the card's name and power limit as nvidia-smi gives them,
              then the build of every kernel (seconds, and the registers
              and spills of K3's bf16 <128, 128> and <192, 128>, of K4's
              split kernel <bf16, 128, 128>, of K5's bf16 split kernel
              <256, 32> and <512, 64> and of K6's bf16 chunk and output
              kernels at N = 128), and the count of tensor-core
              instructions (HMMA, HGMMA) in the SASS of K3's, K5's and
              K6's bf16 libraries where cuobjdump is on the machine; K1's
              and K2's registers and their loads in SASS (LDG, LDGSTS,
              UBLKCP/UTMALDG, the cp.async waits, and the first reader of
              each LDG);
2. returns  — K1 (n-step returns) against its plain PyTorch version on the
              card over E in {1, 8, 31, 32, 33, 256, 4096, 4097}, T in {1,
              5, 64}, on both sides of the short kernel's last T (16, 17)
              and around the longest chunk TC (TC - 1, TC, TC + 1, 2 TC +
              3), T=4096 at E=256 and misaligned views (one element past an
              aligned address) at E=256, gamma in {0, 0.99, 1}, dones at a
              10% rate plus an all-done and a never-done row (|err| <= 1e-5
              + 1e-5 |ref|, and bitwise: any nonzero error fails), with
              CUDA-event times (median of 30, L2 flushed) of the kernel,
              the plain version and the launch floor (an empty kernel of
              the same library at the same grid, launched the same way) at
              (T, E) = (5, 32), the training path's, (5, 256), (64, 4096)
              and (4096, 256), and the wrapper's host microseconds a call
              (1,000 calls on a busy card) at (5, 32);
   vtrace   — K2 (V-trace targets) the same way, over the same E and T
              around its own chunk, (rho_bar, c_bar) in {(1, 1), (2, 1),
              (1e9, 1e9), (inf, inf)} and gamma in {0, 0.99, 1}; rho =
              exp(N(0, 0.5)) with a row of rho = 50, dones at 10% with an
              all-done and a never-done row (bitwise; where unclipped c on
              the rho = 50 row overflows float32 in the plain version, the
              kernel must give the same inf or nan), timed at (5, 32), the
              one-actor pipeline's, (5, 8), (5, 256), (64, 4096) and
              (4096, 256);
3. kernels  — K3 and K4 against their plain versions on the card, at the
              serving path's shapes and at the widths the TPU kernels
              take (K3 q/k and v 112/112 and 192/128, causal, ragged S,
              windowed; K4 at D = 112, v narrower and wider than k,
              per-row pos from 0 to S - 1, S not a multiple of K4's split),
              in fp32 (atol 1e-4) and bf16
              (|err| <= 2e-2 + 2e-2 |ref| against the plain version in
              fp32 on the same bf16 inputs), with CUDA-event times of the
              kernel, the plain version and scaled_dot_product_attention
              (a yardstick only) for K3 at qwen2-7b's prefill and K4 at
              W=8 S=1024 and at the serving decode step (W=4 S=544, pos
              256-264); then K3 at MLA prefill's shape (B=1
              S=512 H=40, q/k 96 wide, v 64), K5 at minicpm3-4b's decode
              shape (W=4 S=544 H=40 R=256 Rr=32, per-row and scalar pos;
              yardstick: SDPA on (q_lat || q_rope) against (c || kr) with
              v = c) and at the split design's edges (K5_EDGES: R = 512
              with H = 128, H = 1 and 17, S = 1, 63, 65, pos past the
              capacity, negative pos giving zeros), and K6 at mamba2-370m's
              prefill shape (B=1 S=512 H=32 P=64 N=128, chunk 128; y and
              the final state, fp32 within 1e-4 + 1e-4 |ref|; no single
              PyTorch call computes it) and at K6_EDGES (every N, chunks
              7, 32, 100, 128, two rows), with the same tolerances and
              times;
4. rl_model — paac_nature at full size in fp32, one set of weights on the
              CPU and on the card: logits and values of 32 frames agree
              within 1e-4, and one PAAC update on the same replayed
              trajectory agrees within 1e-4 on the loss, the global grad
              norm (relative) and every new parameter;
5. training — the paper's setting through ``launch/paper_atari.py``'s code
              path: FrameStack(AtariLike(32)), paac_nature, t_max 5,
              RMSProp, lr 0.0224, seed 0; 10 warm-up iterations, then 200
              timed ones, which must launch K1 exactly once each, keep
              every loss finite, change the parameters and keep the mean
              entropy in (0, log 3]; timesteps/s and the wall of an
              iteration, then a torch.profiler window of 10 iterations
              (device-busy share, device time and launches by kernel
              class), then each layer of an iteration alone (env steps,
              acting forwards, learning pass, K1, optimizer: wall ms,
              device-busy ms, launches); then the entry point itself,
              ``paper_atari --arch paac_nature --n-envs 32 --iters 50``;
              then n_e = 256 for timesteps/s;
   pipeline — the pipelined actor/learner (``PipelinedRL``, device ring,
              thread actors) in the paper's setting (paac_nature,
              FrameStack(AtariLike(32)), fp32): (a) two same-seed
              ParallelRL runs agree bitwise, then lockstep at depth 1 with
              rho_bar = c_bar = inf for 20 iterations equals ParallelRL
              bitwise (metrics and every parameter) and launches K1 20
              times and K2 never (cuDNN deterministic for this part);
              (b) one actor at depth 2, clips 1: 10 warm-up and 200 timed
              updates, K2 launched 200 times and K1 never, losses finite,
              parameters changed, every (actor_id, seq) learned once,
              mean staleness > 0 and the largest <= depth + 1; (c) four
              actors of 8 envs at depth 4, the same checks but the
              staleness bound; timesteps/s, actor/learner idle and a
              profiler window (device-busy share, time two streams are
              busy at once) for (b), (c) and ParallelRL at n_e = 32; then
              ``paper_atari --arch paac_nature --n-envs 32 --iters 50
              --pipeline``;
   agents   — the framework's other agents in the paper's setting
              (paac_nature, FrameStack(AtariLike(32)), fp32, RMSProp, lr
              0.0224, seed 0): (a) one update of DQN (a replayed batch of
              128, a target network unlike the params), lagged PAAC in
              "grad" and "act" mode (a replayed 5x32 trajectory, a stale
              copy unlike the params) and PPO (16x32, 4 epochs) on the CPU
              and on the card: the loss, the global grad norm (relative)
              and every new parameter within 1e-4; (b) each through
              ParallelRL: two same-seed runs of 10 iterations agree
              bitwise (cuDNN deterministic), then 10 warm-up and 50 timed
              iterations with every loss finite, the parameters changed,
              K1 launched once an iteration for lagged PAAC and never for
              DQN and PPO, K2 never; timesteps/s, DQN's replay bytes
              (50,000 transitions) and a profiler window of 10 iterations;
              (c) ``evaluate`` (3 seeds x 30 runs, greedy, max_steps 1,000)
              on the training phase's parameters: best_of_k, mean,
              per_seed and its wall time; (d) ``launch/train.py`` with
              ``--arch paac_vector --n-envs 32 --t-max 5 --iterations 50``,
              then with ``--pipeline`` and with ``--algo dqn``: K1 50
              times, K2 50 times and neither, each with its timesteps/s;
              (e) ``examples/compare_baselines_torch.py`` at 100
              iterations, its four scores in their order;
   host     — the paper's host env plane: a ``HostEnvPool`` of 32
              stand-in emulators (``FrameEnv``: 84x84x4 fp32 frames from
              numpy, 6 actions, ``delay`` s of GIL-free sleep a step) over
              8 worker threads, paac_nature fp32, RMSProp lr 0.0224, t_max
              5: (a) sync ``ParallelRL`` at delay 0, then at the update's
              time over (5 steps x 4 envs a worker) rounded up to 0.1 ms:
              10 warm-up and 100 timed iterations each, K1 once an
              iteration and K2 never, timesteps/s, the collect/update
              split, the update alone, a profiler window (busy share, H2D
              copies); (b) with cuDNN deterministic: two same-seed sync
              runs, lockstep ``PipelinedRL`` (depth 1, inf clips) on the
              same pool recipe and the forced host plane on
              FrameStack(AtariLike(32)) against ``ParallelRL``, bitwise;
              (c) ``PipelinedRL`` on the pool, clips 1, one actor at depth
              2 and four actors on its shards at depth 4, at both delays:
              100 timed updates, K2 once each and K1 never, every
              (actor_id, seq) learned once, staleness within the bound,
              idle shares, spans and busy share; (d) the GIL: one step of
              32 ``PyBoundEnv``s (spin 2000) on 8 workers and on 1, then
              ``launch/train.py --host-env`` sync (K1 50), ``--pipeline``
              (K2 50) and ``--pipeline --metrics-jsonl F --stall-timeout
              30`` (the heartbeat's lines carry the reference's keys); (e)
              ``HostEnvPool.step()`` tensors on the card unchanged by the
              next step, and staging sets overwritten with NaN when
              released change no lockstep update (bitwise); (f) the
              four-actor cell at delay 0 again under
              ``sys.setswitchinterval(0.0005)`` (restored after), its
              timesteps/s and learner update span beside the default's;
              the process actor plane (``actor_backend="process"``:
              spawned workers, each its own interpreter and CUDA context,
              over shared-memory staging sets and a shared-memory param
              slot), on ``HostEnvSpec``s of the same 32 ``FrameEnv``s:
              (g) one worker at depth 2 and four of 8 envs at depth 4,
              clips 1, at both delays: 100 timed updates, K2 once each
              and K1 never, every (actor_id, seq) learned once,
              timesteps/s beside sync and the thread plane, the learner's
              update span and idle share, staleness, the workers' shipped
              spans, the card memory a worker takes, a profiler window of
              the parent's device work (busy share, H2D ms a payload from
              pageable shared memory), and after close() no worker alive
              and no segment of the plane left in /dev/shm; (h) 32
              ``PyBoundEnv``s (spin 2000) on 1, 2, 4 and 8 workers:
              timesteps/s and the workers' own stepping rate; (i) lockstep
              (depth 1, inf clips) on one worker ≡ the thread host plane,
              bitwise with the acting generator's state; (j)
              ``launch/train.py --pipeline --actor-backend process
              --host-env`` (K2 50);
   replay   — the replay plane in the paper's setting (paac_nature,
              FrameStack(AtariLike(32)), fp32): (a) with cuDNN
              deterministic, depth-1 lockstep pipelined DQN ≡
              ``SyncReplayDQN`` over two runs (no kernel), and PAAC at
              capacity 1 (staleness 0) ≡ the FIFO device plane's lockstep
              run at clips 1 (K2) and ≡ ``ParallelRL`` at clips inf; (b)
              one actor on a ring of 64 rollouts (21.7 MB each, ~1.4 GB
              when full): DQN, DQN prioritized at batch 2 and V-trace
              PAAC, 100 timed updates each (K2 once a PAAC update, none for
              DQN), timesteps/s, staleness, learner idle, the update and
              sample spans, peak device memory; (c) ``launch/train.py
              --pipeline --replay`` (K2 50) and ``--pipeline --algo dqn
              --replay`` (none) on TokenEnv;
6. model    — reduced qwen2-7b, minicpm3-4b (absorbed and naive decode)
              and mamba2-370m in fp32, one set of weights on the CPU
              (plain versions) and on the card (kernels): prefill and
              four decode steps (per-row and scalar pos) must agree within
              1e-4 on the logits, and each kernel of the path must launch
              once a layer a call, every other kernel never;
7. serving  — three cells, each at full width and depth with random bf16
              weights from a seed: qwen2-7b (28 layers, d_model 3584;
              K3 prefill, K4 decode), minicpm3-4b with the absorbed decode
              (62 layers, d_model 2560, MLA; K3 prefill with q/k 96 and v
              64 wide, K5 decode) and mamba2-370m (48 layers, d_model
              1024; K6 prefill, recurrent decode in plain PyTorch). Each:
              8 requests over 4 slots, prompts of 128 to 512 tokens (whole
              128-token chunks for mamba2), 16 to 32 new tokens each,
              burst arrival, through the port's continuous-batching entry
              point after a warm-up; every request must finish with tokens
              in [0, vocab), the prefill kernel must launch once a layer
              per admitted request, the decode kernel once a layer per
              decode step and every other kernel never, and one request
              rerun alone on a fresh engine must give bitwise the same
              tokens; a torch.profiler window of 8 decode steps gives the
              device-busy share of a step and the decode kernel's share
              of it, one of 3 prefills of 512 tokens the prefill's device
              time and the prefill kernel's share; then the lockstep
              demo, whose decode runs with a scalar position.

TF32 is off for matmuls and convolutions throughout. The line before the
last is a JSON object with each kernel's numbers and its launches on each
main path (training, pipeline, agents, train cli, host sync, host
pipeline, host train cli, host process, host process train cli, replay,
replay train cli and the three serving cells, each read with the counts
set to 0 just before it); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or when any
phase fails, it exits non-zero and prints no result. ``--trace-dir DIR``
also writes the pipeline runs' Chrome traces (actor, ring and learner
spans) there.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; fp32 off the tensor cores
FP32_ATOL = 1e-4
BF16_TOL = 2e-2
MODEL_ATOL = 1e-4
SSD_TOL = 1e-4  # K6 fp32, absolute and relative: C.B^T sums reach |y| ~ 100
RETURNS_TOL = 1e-5
RL_TOL = 1e-4


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


SPIN_CYCLES = 1_000_000  # ~0.5 ms of the card's clock


def time_ms(torch, fn, flush, iters: int = 30) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` launches, each after
    an L2 flush (the serving path meets each layer's cache cold) and a spin
    of the card (``torch.cuda._sleep``) that lasts longer than the host
    takes to enqueue ``fn``: the start event then fires when ``fn``'s
    launches already wait in the stream, so a wrapper's host time is not
    counted as the kernel's."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def host_us(torch, fn, calls: int = 1000, batch: int = 100) -> float:
    """Host microseconds a call of ``fn``: ``calls`` calls in batches of
    ``batch``, each batch enqueued while the card spins (~10 ms, longer
    than a batch takes to enqueue), so no call waits on the card, and no
    synchronize between the calls of a batch."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // batch):
        torch.cuda._sleep(20 * SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / calls * 1e6


def floor_launch(torch, build, lib: str, shape, T: int, E: int):
    """A function that launches ``lib``'s empty kernel (``<lib>_floor``) at
    the grid, block and shared memory of its real launch at (T, E), through
    ctypes on the current stream, as the wrapper launches the real one: the
    launch floor of a K1 or K2 time."""
    import ctypes

    fn = getattr(build.library(lib), f"{lib}_floor")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tile, chunk, _, _ = shape(T, E)

    def launch():
        rc = fn(T, E, tile, chunk, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"{lib}_floor launch failed: CUDA error {rc}")
    return launch


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
        took = build.build_seconds.get(name)
        say("card", f"built {name}"
            + (f" (nvcc done {took:.1f} s after the build began)" if took else
               " (reused)") + ": " + " | ".join(regs[:4]))
    say("card", f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for src, keys in (("flash_attention_bf16", ("ILi128ELi128E", "ILi192ELi128E")),
                      ("decode_attention", ("I13__nv_bfloat16Li128ELi128E",)),
                      ("mla_decode_bf16", ("ILi256ELi32E", "ILi512ELi64E")),
                      ("ssd_scan_bf16", ("chunk_kernelILi128E",
                                         "out_kernelILi128E"))):
        for key, line in ptxas_lines(build, src, keys):
            say("card", f"{src} {key} {line}")
    for src in ("flash_attention_bf16", "mla_decode_bf16", "ssd_scan_bf16"):
        sass_counts(build, src)
    for src, kernels in (("nstep_returns", ("nstep_kernel",
                                            "nstep_short_kernel")),
                         ("vtrace", ("vtrace_kernel", "vtrace_short_kernel"))):
        for key, line in ptxas_lines(build, src, kernels):
            say("card", f"{src} {key} {line} (dynamic shared memory: "
                "launch_shape's smem_bytes, printed with each time)")
        for kernel in kernels:
            sass_loads(build, src, kernel)
    return card


def ptxas_lines(build, name: str, keys):
    """(instantiation key, "registers | spills") of ``name``'s build log for
    each mangled template key given, e.g. "ILi128ELi128E" for <128, 128>."""
    lines = build.build_log(name).splitlines()
    out = []
    for key in keys:
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and key in ln:
                info = [x.strip() for x in lines[i + 1:i + 4]
                        if "registers" in x or "spill" in x]
                out.append((f"<{key}>", " | ".join(info)))
                break
    return out


def sass_counts(build, name: str) -> None:
    """Tensor-core instructions in ``name``'s library, where cuobjdump is on
    the machine: HMMA (mma.sync) and HGMMA (wgmma)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        say("card", f"{name}: cuobjdump not found; SASS not inspected")
        return
    sass = subprocess.run([tool, "-sass", str(build.target(name))],
                          capture_output=True, text=True, check=True).stdout
    hmma = sum(1 for ln in sass.splitlines() if "HMMA" in ln)
    hgmma = sum(1 for ln in sass.splitlines() if "HGMMA" in ln)
    check(hmma + hgmma > 0, f"{name}: no tensor-core instruction in its SASS")
    say("card", f"{name} SASS: {hmma} HMMA, {hgmma} HGMMA instructions")


SASS_LOADS = ("LDG", "LDGSTS", "LDGDEPBAR", "DEPBAR", "UBLKCP", "UTMALDG",
              "LDS", "STS", "STG", "BAR")


def sass_loads(build, name: str, kernel: str) -> None:
    """The loads of ``kernel`` in ``name``'s SASS, where cuobjdump is on the
    machine: the counts of LDG (a load into registers), LDGSTS (cp.async),
    UBLKCP/UTMALDG (bulk and TMA copies) and the rest of SASS_LOADS, each
    DEPBAR (a wait on the cp.async groups) as written, and for each LDG the
    first later instruction that reads its register: what that load's
    latency stalls."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        say("card", f"{name}: cuobjdump not found; SASS not inspected")
        return
    sass = subprocess.run([tool, "-sass", str(build.target(name))],
                          capture_output=True, text=True, check=True).stdout
    body, inside = [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = f"{len(kernel)}{kernel}E" in ln  # the mangled name
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", ln)
        if inside and m:
            body.append(m.group(1))

    def opcode(ins):
        words = ins.split()
        return words[1] if words[0].startswith("@") else words[0]

    counts = {op: sum(1 for ins in body if opcode(ins).split(".")[0] == op)
              for op in SASS_LOADS}
    check(body, f"{name}: {kernel} not found in its SASS")
    waits = sorted({ins for ins in body if opcode(ins).startswith("DEPBAR")})
    consumers = []
    for i, ins in enumerate(body):
        if opcode(ins).split(".")[0] != "LDG":
            continue
        operands = ins.split(None, 2 if ins.startswith("@") else 1)[-1]
        reg = re.search(r"\bR\d+\b", operands).group(0)
        use = next((f"{opcode(nxt)} (+{j})" for j, nxt in
                    enumerate(body[i + 1:], 1)
                    if re.search(rf"\b{reg}\b", nxt)), "none")
        consumers.append(f"{opcode(ins)} {reg} -> {use}")
    say("card", f"{name} SASS {kernel}: " + ", ".join(
        f"{n} {op}" for op, n in counts.items()) + f"; waits: {waits}")
    say("card", f"{name} SASS {kernel} LDG -> first reader: " + "; ".join(consumers))


FLASH_SWEEP = (  # (B, S, H, Hkv, D, Dv, window), causal
    (1, 512, 28, 4, 128, 128, 0),  # qwen2-7b's prefill (timed in bf16)
    (1, 77, 28, 4, 128, 128, 0),   # ragged S
    (1, 512, 28, 4, 128, 128, 100),
    (1, 333, 16, 4, 112, 112, 0),  # zamba2-7b's width, ragged S
    (1, 200, 16, 4, 112, 112, 64),
    (1, 130, 16, 16, 192, 128, 0),  # deepseek-v2's MLA prefill, ragged S
    (1, 300, 16, 16, 192, 128, 90),
)
DECODE_SWEEP = (  # (W, S, H, Hkv, D, Dv, pos, timed in bf16)
    (8, 1024, 28, 4, 128, 128, [0, 1, 63, 64, 300, 777, 1000, 1023], True),
    (8, 1024, 28, 4, 128, 128, 600, False),
    # qwen2-7b's serving decode step: 4 rows at pos 256-264 of a cache of
    # max_len = 512 + 32 slots, as phase 7's engine allocates it
    (4, 544, 28, 4, 128, 128, [256, 259, 262, 264], True),
    (4, 544, 28, 4, 128, 128, [127, 250, 399, 543], False),
    (4, 300, 16, 4, 112, 112, [0, 63, 64, 299], False),  # S % SPLIT != 0
    (4, 300, 16, 4, 112, 64, [299, 0, 150, 65], False),  # v narrower than k
    (3, 100, 16, 2, 64, 112, [99, 0, 40], False),  # v wider than k
    (2, 40, 16, 4, 112, 128, 39, False),  # S below one split, scalar pos
)


def phase_kernels(torch, np, F, ref, fa, da):
    """K3 and K4 against their plain versions on the card over their sweeps
    (qwen2-7b's shapes and the widths of the TPU kernels), and timed at the
    serving path's shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(getattr(torch, dtype))

    rows = {}
    for dtype in ("float32", "bfloat16"):
        for B, S, H, Hkv, D, Dv, window in FLASH_SWEEP:
            q = randn(B, S, H, D, dtype=dtype)
            k = randn(B, S, Hkv, D, dtype=dtype)
            v = randn(B, S, Hkv, Dv, dtype=dtype)
            out = fa.flash_attention_cuda(q, k, v, causal=True, window=window)
            check(tuple(out.shape) == (B, S, H, Dv), f"K3 out {tuple(out.shape)}")
            plain = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                            causal=True, window=window)
            err = within(torch, out, plain, dtype)
            say("kernels", f"K3 flash_attention {dtype} B={B} S={S} H={H} "
                f"Hkv={Hkv} D={D} Dv={Dv} causal window={window}: max_abs_err "
                f"{err:.3g} ({tolerance(dtype)})")
            row = rows.setdefault("flash_attention", {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if dtype == "bfloat16" and (S, D, window) == (512, 128, 0):
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

    for dtype in ("float32", "bfloat16"):
        for W, S, H, Hkv, D, Dv, pos, timed in DECODE_SWEEP:
            q = randn(W, H, D, dtype=dtype)
            kc = randn(W, S, Hkv, D, dtype=dtype)
            vc = randn(W, S, Hkv, Dv, dtype=dtype)
            p = (torch.tensor(pos, dtype=torch.int32, device=dev)
                 if isinstance(pos, list) else pos)
            out = da.decode_attention_cuda(q, kc, vc, p)
            check(tuple(out.shape) == (W, H, Dv), f"K4 out {tuple(out.shape)}")
            plain = ref.decode_attention_ref(q.float(), kc.float(), vc.float(), p)
            err = within(torch, out, plain, dtype)
            say("kernels", f"K4 decode_attention {dtype} W={W} S={S} H={H} "
                f"Hkv={Hkv} D={D} Dv={Dv} pos={pos}: max_abs_err {err:.3g} "
                f"({tolerance(dtype)})")
            row = rows.setdefault("decode_attention", {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if dtype == "bfloat16" and timed:
                ms = time_ms(torch, lambda: da.decode_attention_cuda(q, kc, vc, p), flush)
                plain_ms = time_ms(torch, lambda: ref.decode_attention_ref(q, kc, vc, p), flush)
                mask = (torch.arange(S, device=dev)[None, :] <= p[:, None])[:, None, None, :]
                q4, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4, kt, vt, attn_mask=mask, enable_gqa=True), flush)
                keys = sum(min(x + 1, S) for x in pos)
                nbytes = 2 * (q.numel() + out.numel() + keys * Hkv * (D + Dv)) + 4 * W
                flops = 2 * H * (D + Dv) * keys
                b_ms, b_by = bound(nbytes, flops, dtype)
                t = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         shape=f"bf16 W={W} S={S} H={H} Hkv={Hkv} D={D} pos={pos}")
                if "ms" in row:  # the serving step's shape, beside the first
                    t["shape"] += " (the serving decode step)"
                    row.setdefault("other", []).append(t)
                else:
                    row.update(t)
                say("kernels", f"K4 timed ({t['shape']}): kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by})")
    del flush
    return rows


def within_rel(torch, out, ref, atol: float, rtol: float, what: str) -> float:
    """Max |out - ref|; fails unless every |out - ref| <= atol + rtol |ref|."""
    err = (out.float() - ref).abs()
    check(bool(torch.isfinite(out.float()).all()), f"{what}: non-finite output")
    check(bool((err <= atol + rtol * ref.abs()).all()),
          f"{what} disagrees with its plain version: max err "
          f"{err.max().item():.3g}")
    return err.max().item()


K5_EDGES = (  # (W, S, H, R, Rr, per-row pos)
    (2, 544, 128, 512, 64, [543, 100]),  # deepseek-v2's widths
    (3, 65, 17, 128, 16, [64, -1, 31]),  # H % 16 != 0, S just past a split
    (2, 63, 40, 32, 32, [62, 0]),        # S below one split, R = 32
    (1, 1, 1, 64, 64, [0]),              # one slot, one head
    (2, 100, 40, 256, 32, [5000, -3]),   # pos past the capacity: all slots
)
K6_EDGES = (  # (B, S, H, N, chunk)
    (2, 200, 6, 16, 100),
    (2, 96, 8, 32, 32),
    (2, 21, 4, 64, 7),
    (2, 256, 4, 128, 128),
)


def phase_latent_kernels(torch, np, F, ref, fa, mk, sk, rows, dev="cuda"):
    """K3 at MLA prefill's shape, K5 at minicpm3-4b's decode shape and K6 at
    mamba2-370m's prefill shape, against their plain versions on the card,
    then timed as ``phase_kernels`` times K3 and K4. Adds to ``rows``."""
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)

    def randn(*shape, dtype="float32"):
        return torch.randn(*shape, generator=g, device=dev).to(getattr(torch, dtype))

    # K3 as MLA prefill runs it: q/k 96 wide (qk_nope 64 + qk_rope 32), v 64
    B, S, H, D, Dv = 1, 512, 40, 96, 64
    k3 = rows["flash_attention"]
    for dtype in ("float32", "bfloat16"):
        q, k = randn(B, S, H, D, dtype=dtype), randn(B, S, H, D, dtype=dtype)
        v = randn(B, S, H, Dv, dtype=dtype)
        out = fa.flash_attention_cuda(q, k, v, causal=True)
        check(tuple(out.shape) == (B, S, H, Dv), f"K3 MLA out {tuple(out.shape)}")
        plain = ref.flash_attention_ref(q.float(), k.float(), v.float())
        err = within(torch, out, plain, dtype)
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
        say("kernels", f"K3 flash_attention {dtype} MLA B={B} S={S} H={H} D={D} "
            f"Dv={Dv} causal: max_abs_err {err:.3g} ({tolerance(dtype)})")
    ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v), flush)
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v), flush)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), flush)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    flops = 2 * (D + Dv) * flash_pairs(np, S, S, True, 0) * H * B
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    shape = f"bf16 B={B} S={S} H={H} D={D} Dv={Dv} causal (MLA prefill)"
    k3.setdefault("other", []).append(
        {"shape": shape, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
         "bound_ms": b_ms, "bound_by": b_by})
    say("kernels", f"K3 timed ({shape}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    # K5 at minicpm3-4b's decode shape, scalar and per-row pos
    W, S, H, R, Rr = 4, 544, 40, 256, 32
    scale = 1.0 / math.sqrt(64 + 32)
    row = {"max_abs_err": 0.0}
    per_row = [127, 250, 399, 543]
    for dtype in ("float32", "bfloat16"):
        ql, qr = randn(W, H, R, dtype=dtype), randn(W, H, Rr, dtype=dtype)
        c, kr = randn(W, S, R, dtype=dtype), randn(W, S, Rr, dtype=dtype)
        for pos in (per_row, 300):
            p = (torch.tensor(pos, dtype=torch.int32, device=dev)
                 if isinstance(pos, list) else pos)
            out = mk.mla_decode_attention_cuda(ql, qr, c, kr, p, scale)
            plain = ref.mla_decode_attention_ref(ql.float(), qr.float(),
                                                 c.float(), kr.float(), p, scale)
            err = within(torch, out, plain, dtype)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            say("kernels", f"K5 mla_decode_attention {dtype} W={W} S={S} H={H} "
                f"R={R} Rr={Rr} pos={pos}: max_abs_err {err:.3g} "
                f"({tolerance(dtype)})")
    # the split design's edges: deepseek-v2's widths, H % 16 != 0, S below
    # and just past one split, one slot, pos past the capacity, and a row
    # with a negative pos (no slot: zeros)
    for dtype in ("float32", "bfloat16"):
        for W2, S2, H2, R2, Rr2, pos in K5_EDGES:
            a, a_r = randn(W2, H2, R2, dtype=dtype), randn(W2, H2, Rr2, dtype=dtype)
            c2, kr2 = randn(W2, S2, R2, dtype=dtype), randn(W2, S2, Rr2, dtype=dtype)
            p2 = torch.tensor(pos, dtype=torch.int32, device=dev)
            out2 = mk.mla_decode_attention_cuda(a, a_r, c2, kr2, p2, scale)
            live = p2 >= 0
            check(bool((out2[~live] == 0).all()), "K5: a row with a negative "
                  "pos is not zeros")
            plain = ref.mla_decode_attention_ref(a.float(), a_r.float(),
                                                 c2.float(), kr2.float(), p2,
                                                 scale)
            err = within(torch, out2[live], plain[live], dtype)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            say("kernels", f"K5 mla_decode_attention {dtype} W={W2} S={S2} "
                f"H={H2} R={R2} Rr={Rr2} pos={pos}: max_abs_err {err:.3g} "
                f"({tolerance(dtype)}; negative pos: zeros)")
    p = torch.tensor(per_row, dtype=torch.int32, device=dev)
    ms = time_ms(torch, lambda: mk.mla_decode_attention_cuda(ql, qr, c, kr, p,
                                                             scale), flush)
    plain_ms = time_ms(torch, lambda: ref.mla_decode_attention_ref(
        ql, qr, c, kr, p, scale), flush)
    # SDPA on (q_lat || q_rope) against (c || kr) with v = c: one KV head
    # shared by the H query heads, the per-row bound as a mask; the
    # concatenations are made once, outside the timed call
    qcat = torch.cat([ql, qr], dim=-1)[:, :, None]
    kcat = torch.cat([c, kr], dim=-1)[:, None]
    mask = (torch.arange(S, device=dev)[None, :] <= p[:, None])[:, None, None, :]
    lib = F.scaled_dot_product_attention(qcat, kcat, c[:, None], attn_mask=mask,
                                         scale=scale, enable_gqa=True)
    lib_err = (lib[:, :, 0].float() - ref.mla_decode_attention_ref(
        ql.float(), qr.float(), c.float(), kr.float(), p, scale)).abs().max().item()
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qcat, kcat, c[:, None], attn_mask=mask, scale=scale, enable_gqa=True),
        flush)
    keys = sum(min(x + 1, S) for x in per_row)
    nbytes = 2 * (ql.numel() + qr.numel() + out.numel() + keys * (R + Rr)) + 4 * W
    flops = 2 * H * keys * (R + Rr) + 2 * H * keys * R
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, shape=f"bf16 W={W} S={S} H={H} R={R} Rr={Rr} "
               f"pos={per_row}")
    rows["mla_decode_attention"] = row
    say("kernels", f"K5 timed ({row['shape']}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (max |sdpa - plain| "
        f"{lib_err:.3g}), bound {b_ms:.4f} ms ({b_by})")

    # K6 at mamba2-370m's prefill shape: y and the final state
    B, S, H, P, N, Q = 1, 512, 32, 64, 128, 128
    A = torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev))
    Dh = torch.ones(H, device=dev)
    row = {"max_abs_err": 0.0, "library_ms": None}
    for dtype in ("float32", "bfloat16"):
        x = randn(B, S, H, P, dtype=dtype)
        dts = F.softplus(randn(B, S, H) - 2.0)
        Bm, Cm = randn(B, S, N, dtype=dtype), randn(B, S, N, dtype=dtype)
        y, st = sk.ssd_scan_cuda(x, dts, A, Bm, Cm, Dh, chunk=Q)
        y_ref, st_ref = ref.ssd_scan_ref(x.float(), dts, A, Bm.float(),
                                         Cm.float(), Dh, chunk=Q)
        tol = SSD_TOL if dtype == "float32" else BF16_TOL
        err = max(within_rel(torch, y, y_ref, tol, tol, f"K6 y {dtype}"),
                  within_rel(torch, st, st_ref, SSD_TOL, SSD_TOL,
                             f"K6 state {dtype}"))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        say("kernels", f"K6 ssd_scan {dtype} B={B} S={S} H={H} P={P} N={N} "
            f"chunk={Q}: max_abs_err {err:.3g} over y and the final state "
            f"(y: atol {tol} + rtol {tol}; state: atol {SSD_TOL} + rtol "
            f"{SSD_TOL}); max |y| {y_ref.abs().max().item():.3g}")
    # every state width, chunks that are not multiples of 16, two rows
    for dtype in ("float32", "bfloat16"):
        for B2, S2, H2, N2, Q2 in K6_EDGES:
            A2 = torch.log(torch.arange(1, H2 + 1, dtype=torch.float32,
                                        device=dev))
            D2 = torch.ones(H2, device=dev)
            x2 = randn(B2, S2, H2, P, dtype=dtype)
            dt2 = F.softplus(randn(B2, S2, H2) - 2.0)
            B2m, C2m = randn(B2, S2, N2, dtype=dtype), randn(B2, S2, N2, dtype=dtype)
            y2, st2 = sk.ssd_scan_cuda(x2, dt2, A2, B2m, C2m, D2, chunk=Q2)
            y2_ref, st2_ref = ref.ssd_scan_ref(x2.float(), dt2, A2, B2m.float(),
                                               C2m.float(), D2, chunk=Q2)
            tol = SSD_TOL if dtype == "float32" else BF16_TOL
            err = max(within_rel(torch, y2, y2_ref, tol, tol, f"K6 y {dtype}"),
                      within_rel(torch, st2, st2_ref, SSD_TOL, SSD_TOL,
                                 f"K6 state {dtype}"))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            say("kernels", f"K6 ssd_scan {dtype} B={B2} S={S2} H={H2} P={P} "
                f"N={N2} chunk={Q2}: max_abs_err {err:.3g} (as above)")
    ms = time_ms(torch, lambda: sk.ssd_scan_cuda(x, dts, A, Bm, Cm, Dh, chunk=Q),
                 flush)
    plain_ms = time_ms(torch, lambda: ref.ssd_scan_ref(x, dts, A, Bm, Cm, Dh,
                                                       chunk=Q), flush)
    nc = S // Q
    tri = Q * (Q + 1) // 2
    flops = B * H * (nc * (2 * N * tri + 2 * P * tri + 2 * Q * P * N)
                     + (nc - 1) * 2 * Q * N * P)  # C.state is 0 in chunk 0
    nbytes = (2 * (2 * x.numel() + Bm.numel() + Cm.numel())
              + 4 * (dts.numel() + 2 * H + st.numel()))
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    row.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               shape=f"bf16 B={B} S={S} H={H} P={P} N={N} chunk={Q}")
    rows["ssd_scan"] = row
    say("kernels", f"K6 timed ({row['shape']}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4g} ms ({b_by}), library none")
    del flush


def device_window(prof, n: int):
    """Device activity of a profiler window of ``n`` iterations: (busy ms an
    iteration as the union of the kernels' and copies' intervals on the
    card, {name: [ms an iteration, launches an iteration]})."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = {}
    for e in events:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += (e.time_range.end - e.time_range.start) / n / 1e3
        row[1] += 1
    for row in by_name.values():
        row[1] /= n
    return busy / n / 1e3, by_name


def kernel_class(name: str) -> str:
    n = name.lower()
    if "nstep" in n:
        return "K1 nstep_returns"
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                            "implicit", "winograd", "fft")):
        return "convolution"
    if any(k in n for k in ("gemm", "nvjet", "cublas", "cutlass", "splitk")):
        return "GEMM"
    if "memcpy" in n or "memset" in n:
        return "copy/set"
    return "elementwise/reduction (env, losses, optimizer)"


RETURNS_E = (1, 8, 31, 32, 33, 256, 4096, 4097)
VTRACE_E = (1, 8, 31, 32, 33, 256, 4096, 4097)
# (T, E) timed, the main path's shape first: K1 at the training path's
# n_e = 32 and 256, K2 at the one-actor and four-actor pipelines and at
# n_e = 256; both at T=64 E=4096 and at the TPU kernel's design point
# T=4096 E=256 (src/repro/kernels/nstep_returns.py:9)
K1_TIMED = ((5, 32), (5, 256), (64, 4096), (4096, 256))
K2_TIMED = ((5, 32), (5, 8), (5, 256), (64, 4096), (4096, 256))


def chunk_edges(mod) -> tuple:
    """T in {1, 5, 64}, both sides of the short kernel's last T (SHORT_T,
    SHORT_T + 1), and around the longest chunk TC: TC - 1, TC, TC + 1 and
    2 TC + 3."""
    tc, st = mod.launch_shape(10**6, 32)[1], mod.column_scan.SHORT_T
    return tuple(sorted({1, 5, 64, st, st + 1, tc - 1, tc, tc + 1,
                         2 * tc + 3}))


def unaligned(torch, x):
    """``x`` copied into a view that starts one element past an aligned
    allocation: contiguous, but not 16-byte (floats) or 4-byte (bytes)
    aligned, so the kernels take their cp.async and byte-load routes."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def timed_rows(torch, phase, name, timed, data, kernel, plain, floor, nbytes,
               flops, shape, flush):
    """CUDA-event times of ``kernel``, its plain version and the launch
    floor at each (T, E) of ``timed``; the first is the main path's shape
    and also gets the wrapper's host microseconds a call."""
    row = {"other": []}
    for i, (T, E) in enumerate(timed):
        args = data[(E, T)]
        ms = time_ms(torch, lambda: kernel(*args), flush)
        # the plain version walks T in Python: fewer repeats at T = 4096
        plain_ms = time_ms(torch, lambda: plain(*args), flush,
                           iters=30 if T < 1000 else 5)
        floor_ms = time_ms(torch, floor(T, E), flush)
        b_ms, b_by = bound(nbytes(T, E), flops(T, E), "float32")
        tile, chunk, blocks, smem = shape(T, E)
        entry = {"shape": f"fp32 T={T} E={E}", "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "launch_floor_ms": floor_ms}
        msg = (f"{name} timed (fp32 T={T} E={E}; tile {tile}, chunk {chunk}, "
               f"{blocks} blocks, {smem} B shared): kernel {ms:.5f} ms, launch "
               f"floor {floor_ms:.5f} ms, plain {plain_ms:.4f} ms, bound "
               f"{b_ms:.3g} ms ({b_by}), library none")
        if i == 0:
            entry["host_us"] = host_us(torch, lambda: kernel(*args))
            msg += f", host {entry['host_us']:.2f} us a call"
            row.update(entry, bound_by=b_by)
        else:
            row["other"].append(entry)
        say(phase, msg)
    return row


def phase_returns(torch, ref, nr, dev="cuda"):
    """K1 against its plain version over the sweep (bitwise), then timed."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    worst, n_cases = 0.0, 0
    data = {}
    T_SWEEP = chunk_edges(nr)
    shapes = [(E, T) for E in RETURNS_E for T in T_SWEEP]
    shapes += [(E, T) for T, E in K1_TIMED if (E, T) not in shapes]
    cases = [(E, T, False) for E, T in shapes] + [
        (256, 5, True), (256, 259, True)]  # misaligned views, E % 16 == 0
    for E, T, view in cases:
        r = torch.randn(T, E, generator=g, device=dev)
        d = torch.rand(T, E, generator=g, device=dev) < 0.1
        if E >= 2:
            d[:, 0], d[:, 1] = True, False  # all done, never done
        b = torch.randn(E, generator=g, device=dev)
        if view:
            r, d = unaligned(torch, r), unaligned(torch, d)
        else:
            data[(E, T)] = (r, d, b, 0.99)
        for gamma in (0.0, 0.99, 1.0):
            out = nr.nstep_returns_cuda(r, d, b, gamma)
            plain = ref.nstep_returns_ref(r, d, b, gamma)
            err = (out - plain).abs()
            check(bool(torch.isfinite(out).all()), "K1: non-finite output")
            check(bool((err <= RETURNS_TOL + RETURNS_TOL * plain.abs()).all()),
                  f"K1 disagrees with its plain version at E={E} T={T} "
                  f"gamma={gamma}: max err {err.max().item():.3g}")
            check(err.max().item() == 0.0,
                  f"K1 is not bitwise its plain version at E={E} T={T} "
                  f"gamma={gamma}: max err {err.max().item():.3g}")
            worst = max(worst, err.max().item())
            n_cases += 1
    say("returns", f"K1 nstep_returns fp32, {n_cases} cases (E in "
        f"{'/'.join(map(str, RETURNS_E))}, T in {'/'.join(map(str, T_SWEEP))}"
        f", T=4096 at E=256, misaligned views at E=256 T=5/259, gamma "
        f"0/0.99/1): max_abs_err {worst:.3g} (atol {RETURNS_TOL} + rtol "
        f"{RETURNS_TOL}; bitwise required)")
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    row = timed_rows(
        torch, "returns", "K1", K1_TIMED, data, nr.nstep_returns_cuda,
        ref.nstep_returns_ref,
        lambda T, E: floor_launch(torch, nr._build, "nstep_returns",
                                  nr.launch_shape, T, E),
        lambda T, E: T * E * (4 + 1 + 4) + 4 * E, lambda T, E: 3 * T * E,
        nr.launch_shape, flush)
    row.update(max_abs_err=worst, library_ms=None)
    del flush
    return row


def phase_vtrace(torch, ref, vt, dev="cuda"):
    """K2 against its plain version over the sweep (bitwise), then timed."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    inf = float("inf")
    worst, n_cases, overflow = 0.0, 0, 0
    data = {}
    T_SWEEP = chunk_edges(vt)
    shapes = [(E, T) for E in VTRACE_E for T in T_SWEEP]
    shapes += [(E, T) for T, E in K2_TIMED if (E, T) not in shapes]
    cases = [(E, T, False) for E, T in shapes] + [
        (256, 5, True), (256, 131, True)]  # misaligned views, E % 16 == 0
    for E, T, view in cases:
        r = torch.randn(T, E, generator=g, device=dev)
        d = torch.rand(T, E, generator=g, device=dev) < 0.1
        v = torch.randn(T, E, generator=g, device=dev)
        rho = torch.exp(0.5 * torch.randn(T, E, generator=g, device=dev))
        if E >= 3:  # all done, never done, rho far above every clip
            d[:, 0], d[:, 1], rho[:, 2] = True, False, 50.0
        b = torch.randn(E, generator=g, device=dev)
        if view:
            r, d, v, rho = (unaligned(torch, x) for x in (r, d, v, rho))
        else:
            data[(E, T)] = (r, d, v, b, rho, 0.99, 1.0, 1.0)
        for rho_bar, c_bar in ((1.0, 1.0), (2.0, 1.0), (1e9, 1e9),
                               (inf, inf)):
            for gamma in (0.0, 0.99, 1.0):
                args = (r, d, v, b, rho, gamma, rho_bar, c_bar)
                for out, plain in zip(vt.vtrace_returns_cuda(*args),
                                      ref.vtrace_returns_ref(*args)):
                    # unclipped c over the rho = 50 row overflows float32 in
                    # both versions (50^T): there the kernel must give
                    # exactly the plain version's inf or nan
                    fin = torch.isfinite(plain)
                    check(bool((torch.isfinite(out) == fin).all())
                          and bool((out[~fin].nan_to_num(0.0, 1.0, -1.0)
                                    == plain[~fin].nan_to_num(
                                        0.0, 1.0, -1.0)).all()),
                          f"K2 non-finite where its plain version is not "
                          f"(or the other way) at E={E} T={T} clips="
                          f"({rho_bar}, {c_bar}) gamma={gamma}")
                    overflow += int((~fin).sum())
                    err = (out[fin] - plain[fin]).abs()
                    check(bool((err <= RETURNS_TOL
                                + RETURNS_TOL * plain[fin].abs()).all()),
                          f"K2 disagrees with its plain version at E={E} "
                          f"T={T} clips=({rho_bar}, {c_bar}) gamma="
                          f"{gamma}: max err {err.max().item():.3g}")
                    if err.numel():
                        check(err.max().item() == 0.0,
                              f"K2 is not bitwise its plain version at E={E} "
                              f"T={T} clips=({rho_bar}, {c_bar}) gamma="
                              f"{gamma}: max err {err.max().item():.3g}")
                        worst = max(worst, err.max().item())
                n_cases += 1
    say("vtrace", f"K2 vtrace_returns fp32, {n_cases} cases (E in "
        f"{'/'.join(map(str, VTRACE_E))}, T in "
        f"{'/'.join(map(str, T_SWEEP))}, T=4096 at E=256, misaligned views "
        "at E=256 T=5/131, clips (1,1)/(2,1)/(1e9,1e9)/(inf,inf), gamma "
        "0/0.99/1, a row of rho=50): "
        f"max_abs_err {worst:.3g} over vs and pg_adv (atol {RETURNS_TOL} + "
        f"rtol {RETURNS_TOL}; bitwise required); {overflow} entries overflow "
        "float32 in both versions (unclipped c on the rho=50 row) and match "
        "exactly")
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    row = timed_rows(
        torch, "vtrace", "K2", K2_TIMED, data, vt.vtrace_returns_cuda,
        ref.vtrace_returns_ref,
        lambda T, E: floor_launch(torch, vt._build, "vtrace", vt.launch_shape,
                                  T, E),
        lambda T, E: T * E * (4 + 1 + 4 + 4) + 2 * T * E * 4 + 4 * E,
        lambda T, E: 15 * T * E, vt.launch_shape, flush)
    row.update(max_abs_err=worst, library_ms=None)
    del flush
    return row


def phase_rl_model(torch, configs, models, envs, paac, optim, tree,
                   dev="cuda"):
    """paac_nature at full size, fp32: the CPU against the card."""
    cfg = configs.get_config("paac_nature").replace(num_actions=3)
    check((cfg.cnn_spec, cfg.cnn_dense, cfg.obs_shape, cfg.param_dtype)
          == (((32, 8, 4), (64, 4, 2), (64, 3, 1)), 512, (84, 84, 4),
              "float32"), f"not the full paac_nature config: {cfg}")
    cpu = models.init_policy(cfg, generator=torch.Generator().manual_seed(SEED),
                             device="cpu")
    gpu = tree.tree_map(lambda t: t.to(dev), cpu)
    n_params = sum(t.numel() for t in tree.tree_leaves(cpu))

    env = envs.FrameStack(envs.AtariLike(32, device="cpu"), 4)
    hp = paac.PAACConfig(gamma=0.99, entropy_beta=0.01, t_max=5)
    agent = paac.PAACAgent(cfg, hp)
    g = torch.Generator().manual_seed(SEED)
    state = env.reset(g)
    _, _, traj, boot = agent.make_collect_step(env)(
        cpu, state, env.observe(state), torch.Generator().manual_seed(SEED + 1),
        g)
    traj_g = type(traj)(*(x.to(dev) for x in traj))
    boot_g = boot.to(dev)

    obs = traj.obs[1]  # 32 frames a few steps into episodes
    lc, vc, _ = models.policy_apply(cpu, cfg, obs)
    lg, vg, _ = models.policy_apply(gpu, cfg, obs.to(dev))
    fwd = max((lc - lg.cpu()).abs().max().item(),
              (vc - vg.cpu()).abs().max().item())
    check(fwd <= RL_TOL, f"paac_nature logits/values: card vs CPU {fwd:.3g}")

    loss_c, _, grads_c = paac.loss_and_grads(cpu, cfg, hp, traj, boot)
    loss_g, _, grads_g = paac.loss_and_grads(gpu, cfg, hp, traj_g, boot_g)
    gn_c = tree.tree_global_norm(grads_c).item()
    gn_g = tree.tree_global_norm(grads_g).item()
    opt = optim.make_optimizer("rmsprop")
    update = agent.make_update_step(opt, optim.constant(0.0007 * 32))
    new_c, _, _ = update(cpu, opt.init(cpu), traj, boot, 0)
    new_g, _, _ = update(gpu, opt.init(gpu), traj_g, boot_g, 0)
    d_loss = abs(loss_c.item() - loss_g.item())
    d_norm = abs(gn_c - gn_g) / max(1.0, abs(gn_c))
    d_param = max((a - b.cpu()).abs().max().item() for a, b in
                  zip(tree.tree_leaves(new_c), tree.tree_leaves(new_g)))
    moved = max((a - b).abs().max().item() for a, b in
                zip(tree.tree_leaves(new_c), tree.tree_leaves(cpu)))
    check(d_loss <= RL_TOL, f"PAAC loss: card vs CPU {d_loss:.3g}")
    check(d_norm <= RL_TOL, f"global grad norm: card {gn_g} vs CPU {gn_c}")
    check(d_param <= RL_TOL, f"new parameters: card vs CPU {d_param:.3g}")
    check(moved > 10 * RL_TOL, f"the update moved no parameter ({moved:.3g})")
    say("rl_model", f"paac_nature full size fp32 ({n_params / 1e6:.2f} M "
        f"parameters): logits/values of 32 frames card vs CPU max {fwd:.3g}; "
        f"one update on a replayed 5x32 trajectory: loss {loss_c.item():.6f} "
        f"(|d| {d_loss:.3g}), grad norm {gn_c:.6f} (rel d {d_norm:.3g}), new "
        f"params max |d| {d_param:.3g} (largest step {moved:.3g}); all <= "
        f"{RL_TOL}")


def measure(torch, fn, n: int):
    """(host wall ms a call over ``n`` calls ended by a device drain,
    device-busy ms a call, device activities a call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy_ms, by_name = device_window(prof, n)
    return host_ms, busy_ms, sum(c for _, c in by_name.values())


def layer_costs(torch, rl, n: int):
    """The layers of one iteration, each run alone: the env steps and the
    acting forwards of a rollout, the learning pass (forward over all
    frames, K1, losses, backward), K1 alone and the optimizer."""
    from repro_torch.core.agents.paac import loss_and_grads
    from repro_torch.kernels import ops
    from repro_torch.utils.sampling import categorical

    agent, env, hp = rl.agent, rl.env, rl.agent.hp
    act = agent.act_fn()
    g = torch.Generator(device=rl.device).manual_seed(SEED)
    _, _, traj, boot = agent.make_collect_step(env)(
        rl.params, rl.env_state, rl.obs, g, g)
    _, _, grads = loss_and_grads(rl.params, agent.cfg, hp, traj, boot)
    lr = rl.lr_schedule(0)

    def env_steps():
        for t in range(hp.t_max):
            env.step(rl.env_state, traj.action[t], g)

    def acting():
        with torch.no_grad():
            for _ in range(hp.t_max + 1):  # the last one is the bootstrap
                categorical(act(rl.params, rl.obs)[0], g)

    fns = {
        f"env step x{hp.t_max}": env_steps,
        f"acting forward + draw x{hp.t_max + 1}": acting,
        "learning pass": lambda: loss_and_grads(rl.params, agent.cfg, hp,
                                                traj, boot),
        "K1": lambda: ops.nstep_returns(traj.reward, traj.done, boot,
                                        hp.gamma),
        "optimizer": lambda: rl.optimizer.update(grads, rl.opt_state,
                                                 rl.params, lr),
    }
    return {k: measure(torch, fn, n) for k, fn in fns.items()}


def phase_training(torch, paper_atari, ops, tree, card, dev="cuda",
                   n_envs=32, warmup=10, iters=200, window=10, wide=256,
                   wide_iters=50):
    """The paper's setting, timed; returns the launch counts of the run and
    the trained ``(agent, params)``."""
    from torch.profiler import ProfilerActivity, profile

    rl = paper_atari.build("paac_nature", n_envs, SEED, dev)
    check(rl.lr_schedule(0) == 0.0007 * n_envs, "lr is not 0.0007 n_e")
    check(rl.env.obs_shape == (84, 84, 4) and rl.env.num_actions == 3,
          f"env obs {rl.env.obs_shape}, {rl.env.num_actions} actions")
    rl.run(warmup)
    before = [t.clone() for t in tree.tree_leaves(rl.params)]
    ops.reset_launches()
    res = rl.run(iters)
    counts = dict(ops.launches)
    m = res.mean_metrics
    check(counts["nstep_returns"] == iters,
          f"K1 launched {counts['nstep_returns']} times in {iters} iterations")
    # a non-finite loss in any iteration makes the mean non-finite
    check(all(math.isfinite(v) for v in m.values()),
          f"non-finite training metrics: {m}")
    changed = max((a - b).abs().max().item() for a, b in
                  zip(before, tree.tree_leaves(rl.params)))
    check(changed > 0, "the parameters did not change")
    check(0 < m["entropy"] <= math.log(3) + 1e-6,
          f"mean entropy {m['entropy']} outside (0, log 3]")
    iter_ms = 1e3 * n_envs * rl.agent.hp.t_max / res.timesteps_per_sec
    say("training", f"paac_nature on FrameStack(AtariLike({n_envs})), t_max 5, "
        f"RMSProp lr {0.0007 * n_envs:g}: {iters} iterations after {warmup} "
        f"warm-up, K1 launched {counts['nstep_returns']} times; "
        f"{res.timesteps_per_sec:.1f} timesteps/s, {iter_ms:.2f} ms an "
        f"iteration; mean loss {m['loss']:.4f}, entropy {m['entropy']:.4f}, "
        f"reward/iter {m['reward_sum']:+.3f}, episodes {res.episodes:.0f}; "
        f"largest parameter change {changed:.3g} ({card})")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rl.run(window)
        torch.cuda.synchronize()
    busy_ms, by_name = device_window(prof, window)
    classes = {}
    for name, (ms, n) in by_name.items():
        row = classes.setdefault(kernel_class(name), [0.0, 0.0])
        row[0] += ms
        row[1] += n
    launches = sum(n for _, n in by_name.values())
    busy = (f"device busy {busy_ms:.3f} ms an iteration "
            f"({100 * busy_ms / iter_ms:.1f}% of the unprofiled {iter_ms:.2f} "
            "ms)" if busy_ms > 0 else "device time not measured (the "
            "profiler saw no device activity)")
    say("training", f"torch.profiler window of {window} iterations: {busy}, "
        f"{launches:.0f} device activities an iteration; by class (ms, "
        "launches an iteration): "
        + "; ".join(f"{k} {ms:.3f} x{n:.0f}" for k, (ms, n) in
                    sorted(classes.items(), key=lambda kv: -kv[1][0])))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    say("training", "top device activities (ms, launches an iteration): "
        + "; ".join(f"{k[:60]} {ms:.3f} x{n:.0f}" for k, (ms, n) in top))

    layers = layer_costs(torch, rl, window)
    say("training", "each layer alone, at the state the run reached (host "
        "wall ms with the device drained, device-busy ms, launches; a "
        "call): " + "; ".join(f"{k} {h:.3f} / {b:.3f} / {n:.0f}" for k, (h, b, n)
                              in layers.items()))

    trained = (rl.agent, rl.params)
    del rl
    argv = ["--arch", "paac_nature", "--n-envs", str(n_envs), "--iters", "50",
            "--seed", str(SEED), "--device", str(dev)]
    cli = paper_atari.main(argv)
    check(len(cli) == 2 and cli[-1].steps == 50 * n_envs * 5
          and all(math.isfinite(v) for r in cli for v in r.mean_metrics.values()),
          f"paper_atari {' '.join(argv)}: {cli}")
    say("training", f"entry point: python -m repro_torch.launch.paper_atari "
        f"{' '.join(argv)}: {cli[-1].steps} steps in 2 epochs, "
        f"{cli[-1].timesteps_per_sec:.1f} timesteps/s in the second")

    wide_rl = paper_atari.build("paac_nature", wide, SEED, dev)
    wide_rl.run(warmup)
    wres = wide_rl.run(wide_iters)
    check(all(math.isfinite(v) for v in wres.mean_metrics.values()),
          f"non-finite metrics at n_e={wide}")
    say("training", f"n_e={wide} (lr {0.0007 * wide:g}): {wide_iters} "
        f"iterations after {warmup} warm-up, {wres.timesteps_per_sec:.1f} "
        f"timesteps/s, {1e3 * wide * 5 / wres.timesteps_per_sec:.2f} ms an "
        "iteration")
    return counts, trained


SHARED_METRICS = ("loss", "policy_loss", "value_loss", "entropy",
                  "reward_sum", "episodes")


DQN_METRICS = ("loss", "q_mean", "td_abs", "reward_sum", "episodes")


def check_bitwise(torch, tree, ra, a, rb, b, what: str,
                  keys=SHARED_METRICS) -> None:
    """Two runs' mean metrics ``keys`` and every parameter leaf are
    equal."""
    for k in keys:
        check(ra.mean_metrics[k] == rb.mean_metrics[k],
              f"{what}: mean {k} {ra.mean_metrics[k]!r} != "
              f"{rb.mean_metrics[k]!r}")
    diff = [i for i, (x, y) in enumerate(zip(tree.tree_leaves(a.params),
                                             tree.tree_leaves(b.params)))
            if not torch.equal(x, y)]
    check(not diff, f"{what}: parameter leaves {diff} differ")


def _merge(intervals):
    """Sorted, merged copies of ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def stream_overlap(prof, n: int):
    """(ms an iteration during which work of two or more CUDA streams runs
    at once, {stream id: busy ms an iteration}) of a profiler window."""
    from torch.autograd import DeviceType

    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per.setdefault(e.device_resource_id, []).append(
                (e.time_range.start, e.time_range.end))
    busy, edges = {}, []
    for sid, iv in per.items():
        merged = _merge(iv)
        busy[sid] = sum(b - a for a, b in merged) / n / 1e3
        edges += [(a, 1) for a, _ in merged] + [(b, -1) for _, b in merged]
    both, depth, last = 0.0, 0, 0.0
    for t, step in sorted(edges):
        if depth >= 2:
            both += t - last
        depth, last = depth + step, t
    return both / n / 1e3, busy


def span_overlap(hub) -> float:
    """Share of the learner's update spans (host clock) during which some
    actor was inside its collect span."""
    from repro_torch.telemetry.spans import COLLECT, LEARNER_UPDATE

    updates, collects = [], []
    for _, _, em in hub.tracks():
        for cat, t0, t1 in em.snapshot():
            if em.name == "learner" and cat == LEARNER_UPDATE:
                updates.append((t0, t1))
            elif em.name.startswith("actor") and cat == COLLECT:
                collects.append((t0, t1))
    merged = _merge(collects)
    inter = sum(max(0.0, min(b, d) - max(a, c))
                for a, b in updates for c, d in merged)
    total = sum(b - a for a, b in updates)
    return inter / total if total > 0 else 0.0


def span_means(hub) -> str:
    """Mean host ms of each (track, stage) span of a run: the learner's
    ring wait, lease wait, update and publish, the actors' collect and
    ring wait."""
    from repro_torch.telemetry.spans import CATEGORIES

    sums = {}
    for _, _, em in hub.tracks():
        who = "actors" if em.name.startswith("actor") else em.name
        if who in ("ring", "queue"):  # the parties' own waits, again
            continue
        for cat, t0, t1 in em.snapshot():
            row = sums.setdefault((who, CATEGORIES[cat]), [0.0, 0])
            row[0] += (t1 - t0) * 1e3
            row[1] += 1
    return ", ".join(f"{who} {cat} {ms / n:.3f} x{n}"
                     for (who, cat), (ms, n) in sorted(sums.items()))


def span_stat(hub, track: str, stage: str):
    """(mean host ms, count) of the ``stage`` spans of the tracks whose
    name starts with ``track`` (shipped worker rings included)."""
    ms, n = 0.0, 0
    for _, _, em in hub.tracks():
        if em.name.startswith(track):
            for cat, t0, t1 in em.snapshot():
                if em.categories[cat] == stage:
                    ms += (t1 - t0) * 1e3
                    n += 1
    return (ms / n if n else float("nan")), n


def phase_pipeline(torch, paper_atari, configs, ops, tree, card, dev="cuda",
                   n_envs=32, warmup=10, iters=200, lock_iters=20, window=10,
                   trace_dir=None):
    """The pipelined actor/learner in the paper's setting: lockstep against
    ParallelRL bitwise, then one and four actors timed beside ParallelRL.
    Returns K2's launches in the one-actor run."""
    from torch.profiler import ProfilerActivity, profile

    PipelineConfig = configs.PipelineConfig
    leaves = tree.tree_leaves
    inf = float("inf")

    def bitwise(ra, a, rb, b, what):
        check_bitwise(torch, tree, ra, a, rb, b, what)

    # (a) lockstep, infinite clips: the synchronous update, bit for bit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        sync = [paper_atari.build("paac_nature", n_envs, SEED, dev)
                for _ in range(2)]
        sync_res = [rl.run(lock_iters) for rl in sync]
        bitwise(sync_res[0], sync[0], sync_res[1], sync[1],
                "two same-seed ParallelRL runs on the card")
        lock = paper_atari.build("paac_nature", n_envs, SEED, dev,
                                 PipelineConfig(queue_depth=1, lockstep=True,
                                                rho_bar=inf, c_bar=inf))
        ops.reset_launches()
        lock_res = lock.run(lock_iters)
        counts = dict(ops.launches)
        check(counts["nstep_returns"] == lock_iters
              and counts["vtrace_returns"] == 0,
              f"lockstep launches {counts}, not K1 x{lock_iters} and no K2")
        check(lock.staleness == [0.0] * lock_iters,
              f"lockstep staleness {lock.staleness}")
        bitwise(lock_res, lock, sync_res[0], sync[0],
                "lockstep PipelinedRL vs ParallelRL")
    finally:
        torch.backends.cudnn.deterministic = False
    say("pipeline", f"(a) two same-seed ParallelRL runs of {lock_iters} "
        "iterations agree bitwise; lockstep PipelinedRL (depth 1, rho_bar = "
        f"c_bar = inf) equals them bitwise in every metric and all "
        f"{len(leaves(lock.params))} parameter leaves; launches K1 "
        f"{counts['nstep_returns']}, K2 {counts['vtrace_returns']}")
    del sync, lock

    def timed(label, key, rl, expect):
        rl.run(warmup)
        before = [t.clone() for t in leaves(rl.params)]
        ops.reset_launches()
        res = rl.run(iters)
        counts = dict(ops.launches)
        m = res.mean_metrics
        check(all(math.isfinite(v) for v in m.values()),
              f"{label}: non-finite metrics {m}")
        changed = max((a - b).abs().max().item() for a, b in
                      zip(before, leaves(rl.params)))
        check(changed > 0, f"{label}: the parameters did not change")
        expect(rl, res, counts)
        hub = getattr(rl, "telemetry", None)
        host_overlap = span_overlap(hub) if hub is not None else None
        if hub is not None:
            say("pipeline", f"{label}: mean host ms of each span (track, "
                f"stage, count): {span_means(hub)}")
        if trace_dir and hub is not None:
            hub.write_trace(os.path.join(trace_dir, f"pipeline_{key}.json"))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rl.run(window)
            torch.cuda.synchronize()
        busy_ms, _ = device_window(prof, window)
        both_ms, streams = stream_overlap(prof, window)
        per_iter = rl._steps_per_iter  # timesteps an update
        iter_ms = 1e3 * per_iter / res.timesteps_per_sec
        wall_s = iters * iter_ms / 1e3
        n_act = len(res.per_actor_idle_s) or 1
        row = dict(tps=res.timesteps_per_sec, iter_ms=iter_ms,
                   busy_ms=busy_ms, both_ms=both_ms,
                   actor_idle=res.actor_idle_s / (n_act * wall_s),
                   learner_idle=res.learner_idle_s / wall_s)
        say("pipeline", f"{label}: {iters} updates after {warmup} warm-up, "
            f"launches K1 {counts['nstep_returns']} K2 "
            f"{counts['vtrace_returns']}; {res.timesteps_per_sec:.1f} "
            f"timesteps/s, {iter_ms:.2f} ms an update of {per_iter} "
            f"timesteps; mean loss {m['loss']:.4f}, entropy "
            f"{m['entropy']:.4f}, rho_mean {m.get('rho_mean', 1.0):.4f}, "
            f"rho_clip_frac {m.get('rho_clip_frac', 0.0):.4f}, staleness "
            f"{m.get('staleness', 0.0):.3f}; actor idle {res.actor_idle_s:.3f}"
            f" s ({100 * row['actor_idle']:.1f}% of each actor's wall), "
            f"learner idle {res.learner_idle_s:.3f} s "
            f"({100 * row['learner_idle']:.1f}%); learner update spans "
            "overlapping an actor's collect span: "
            + ("n/a" if host_overlap is None else f"{100 * host_overlap:.1f}%")
            + f"; profiler window of {window}: device busy {busy_ms:.3f} ms "
            f"an update ({100 * busy_ms / iter_ms:.1f}% of the unprofiled "
            f"{iter_ms:.2f} ms), two or more streams busy at once "
            f"{both_ms:.3f} ms; busy ms by stream "
            + ", ".join(f"{k}: {v:.3f}" for k, v in sorted(streams.items()))
            + f" ({card})")
        return row, counts

    def one_actor(rl, res, counts):
        check(counts["vtrace_returns"] == iters
              and counts["nstep_returns"] == 0,
              f"one actor: launches {counts}, not K2 x{iters} and no K1")
        check(sorted(rl.learned_ids) == [(0, s) for s in range(iters)],
              "one actor: an (actor_id, seq) was dropped or learned twice")
        check(res.mean_metrics["staleness"] > 0
              and max(rl.staleness) <= rl.pipeline.queue_depth + 1,
              f"one actor: staleness mean {res.mean_metrics['staleness']} "
              f"max {max(rl.staleness)}")
        check(0 < res.mean_metrics["rho_mean"] < math.inf,
              f"one actor: rho_mean {res.mean_metrics['rho_mean']}")

    def four_actors(rl, res, counts):
        check(counts["vtrace_returns"] == iters
              and counts["nstep_returns"] == 0,
              f"four actors: launches {counts}, not K2 x{iters} and no K1")
        check(sorted(rl.learned_ids) == [(a, s) for a in range(4)
                                         for s in range(iters // 4)],
              "four actors: an (actor_id, seq) was dropped or learned twice")
        check(0 < res.mean_metrics["rho_mean"] < math.inf,
              f"four actors: rho_mean {res.mean_metrics['rho_mean']}")

    def synchronous(rl, res, counts):
        check(counts["nstep_returns"] == iters
              and counts["vtrace_returns"] == 0,
              f"ParallelRL: launches {counts}")

    rows = {}
    rows["sync"], _ = timed(f"ParallelRL n_e={n_envs}", "sync",
                            paper_atari.build("paac_nature", n_envs, SEED, dev),
                            synchronous)
    rows["one"], counts = timed(
        "(b) one actor, depth 2", "one_actor",
        paper_atari.build("paac_nature", n_envs, SEED, dev,
                          PipelineConfig(queue_depth=2)), one_actor)
    rows["four"], _ = timed(
        f"(c) four actors of {n_envs // 4} envs, depth 4", "four_actors",
        paper_atari.build("paac_nature", n_envs, SEED, dev,
                          PipelineConfig(queue_depth=4, num_actors=4)),
        four_actors)
    say("pipeline", "timesteps/s: " + ", ".join(
        f"{k} {r['tps']:.1f} ({r['tps'] / rows['sync']['tps']:.2f}x sync)"
        for k, r in rows.items()))

    argv = ["--arch", "paac_nature", "--n-envs", str(n_envs), "--iters", "50",
            "--seed", str(SEED), "--device", str(dev), "--pipeline"]
    cli = paper_atari.main(argv)
    check(len(cli) == 2 and cli[-1].steps == 50 * n_envs * 5
          and all(math.isfinite(v) for r in cli for v in r.mean_metrics.values()),
          f"paper_atari {' '.join(argv)}: {cli}")
    say("pipeline", f"entry point: python -m repro_torch.launch.paper_atari "
        f"{' '.join(argv)}: {cli[-1].steps} steps in 2 epochs, "
        f"{cli[-1].timesteps_per_sec:.1f} timesteps/s in the second, "
        f"staleness {cli[-1].mean_metrics['staleness']:.2f}")
    return counts["vtrace_returns"]


def _grad_norm(torch, tree, loss_fn, params) -> float:
    """Global L2 norm of the gradient of ``loss_fn(params)[0]`` (zero for the
    leaves the loss does not reach)."""
    leaves = [p.detach().requires_grad_(True) for p in tree.tree_leaves(params)]
    with torch.enable_grad():
        loss, _ = loss_fn(tree.tree_unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return tree.tree_global_norm(list(grads)).item()


AGENT_NAMES = ("dqn", "lagged grad", "lagged act", "ppo")


def make_agent(A, name: str, cfg):
    """The agents of the ``agents`` phase, each with the reference's
    default hyperparameters (lagged PAAC: t_max 5, delay 4; DQN: t_max 5,
    batch 128, target sync 100; PPO: t_max 16, 4 epochs)."""
    if name == "dqn":
        return A.DQNAgent(cfg, A.DQNConfig())
    if name == "ppo":
        return A.PPOAgent(cfg, A.PPOConfig())
    return A.LaggedPAACAgent(cfg, A.LaggedConfig(), name.split()[1])


def agents_card_vs_cpu(torch, configs, models, envs, A, replay, core, optim,
                       tree, dev="cuda"):
    """(a) One update of each agent on the same replayed data, on the CPU
    and on the card."""
    cfg = configs.get_config("paac_nature").replace(num_actions=3)
    cpu = models.init_policy(cfg, generator=torch.Generator().manual_seed(SEED),
                             device="cpu")
    # the stale copy of lagged PAAC and DQN's target network
    other = models.init_policy(
        cfg, generator=torch.Generator().manual_seed(SEED + 2), device="cpu")
    env = envs.FrameStack(envs.AtariLike(32, device="cpu"), 4)
    g = torch.Generator().manual_seed(SEED)
    state = env.reset(g)
    collect = A.PAACAgent(cfg, A.PAACConfig(t_max=16)).make_collect_step(env)
    _, _, traj, boot = collect(cpu, state, env.observe(state),
                               torch.Generator().manual_seed(SEED + 1), g)
    buf = replay.replay_init(16 * 32, env.obs_shape, device="cpu")
    for t in range(15):
        replay.replay_add(buf, traj.obs[t], traj.action[t], traj.reward[t],
                          traj.obs[t + 1], traj.done[t])
    batch = replay.replay_sample(buf, torch.Generator().manual_seed(SEED), 128)
    rms = optim.make_optimizer("rmsprop")
    lr = optim.constant(0.0007 * 32)
    to = lambda d: (lambda x: tree.tree_map(lambda t: t.to(d), x))  # noqa: E731
    Tr = type(traj)

    def run(name, d):
        mv = to(d)
        p, o, tr = mv(cpu), mv(other), Tr(*(x.to(d) for x in traj))
        agent = make_agent(A, name, cfg)
        if name == "dqn":
            bt = mv(batch)
            new, _, _, m = agent.make_update_step(rms, lr)(
                p, rms.init(p), {"target": o, "updates": 0}, bt, 0)
            gn = _grad_norm(torch, tree, lambda q: A.dqn.dqn_loss(
                q, o, bt, cfg, agent.hp.gamma), p)
        elif name == "ppo":
            b = boot.to(d)
            new, _, m = agent.make_update_step(rms, lr)(p, rms.init(p), tr, b,
                                                        0)
            adv, ret = core.gae_advantages(tr.reward, tr.done, tr.value, b,
                                           agent.hp.gamma, agent.hp.lam)
            gn = _grad_norm(torch, tree, lambda q: A.ppo.ppo_loss(
                q, cfg, agent.hp, tr, adv, ret), p)  # the first epoch's
        else:  # t_max 5: the first five steps, bootstrapped by V(s_6)
            short, sb = Tr(*(x[:5] for x in tr)), tr.value[5]
            new, _, _, m = agent.make_lagged_update(rms, lr)(
                p, rms.init(p), {"stale": o, "since": 0}, short, sb, 0)
            _, _, grads = A.paac.loss_and_grads(
                o if agent.mode == "grad" else p, cfg, agent.hp, short, sb)
            gn = tree.tree_global_norm(grads).item()
        return m["loss"].item(), gn, new

    for name in AGENT_NAMES:
        loss_c, gn_c, new_c = run(name, "cpu")
        loss_g, gn_g, new_g = run(name, dev)
        d_loss = abs(loss_c - loss_g)
        d_norm = abs(gn_c - gn_g) / max(1.0, abs(gn_c))
        d_param = max((a - b.cpu()).abs().max().item() for a, b in
                      zip(tree.tree_leaves(new_c), tree.tree_leaves(new_g)))
        moved = max((a - b).abs().max().item() for a, b in
                    zip(tree.tree_leaves(new_c), tree.tree_leaves(cpu)))
        check(d_loss <= RL_TOL, f"{name} loss: card vs CPU {d_loss:.3g}")
        check(d_norm <= RL_TOL, f"{name} grad norm: card {gn_g} vs CPU {gn_c}")
        check(d_param <= RL_TOL, f"{name} new parameters: card vs CPU "
              f"{d_param:.3g}")
        check(moved > 10 * RL_TOL, f"{name}: the update moved no parameter "
              f"({moved:.3g})")
        say("agents", f"(a) {name}, paac_nature full size fp32, one update "
            + ("on a replayed batch of 128" if name == "dqn" else
               "on a replayed 16x32 trajectory, 4 epochs" if name == "ppo"
               else "on a replayed 5x32 trajectory, stale copy unlike the "
               "params")
            + f": loss {loss_c:.6f} (|d| {d_loss:.3g}), grad norm {gn_c:.6f} "
            f"(rel d {d_norm:.3g}), new params max |d| {d_param:.3g} (largest "
            f"step {moved:.3g}); all <= {RL_TOL}")


def phase_agents(torch, configs, models, envs, A, replay, core, optim, tree,
                 ops, train, card, trained, dev="cuda", n_envs=32, warmup=10,
                 iters=50, lock_iters=10, window=10, replay_capacity=50_000,
                 eval_steps=1_000, cli_iters=50, compare_iters=100):
    """The framework's other agents in the paper's setting, ``evaluate`` on
    the parameters the training phase trained, the trainer's three legs and
    the baselines example. Returns the launch counts of the agents' timed
    runs and of the trainer's legs."""
    from torch.profiler import ProfilerActivity, profile

    leaves = tree.tree_leaves
    agents_card_vs_cpu(torch, configs, models, envs, A, replay, core, optim,
                       tree, dev)

    def build(name):
        env = envs.FrameStack(envs.AtariLike(n_envs, device=dev), 4)
        cfg = configs.get_config("paac_nature").replace(
            obs_shape=env.obs_shape, num_actions=env.num_actions)
        return core.ParallelRL(env, make_agent(A, name, cfg),
                               optimizer="rmsprop",
                               lr_schedule=optim.constant(0.0007 * n_envs),
                               seed=SEED, replay_capacity=replay_capacity,
                               device=dev)

    # (b) each agent through ParallelRL: one seed, one run (cuDNN
    # deterministic for this part), then timed
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for name in AGENT_NAMES:
            runs = []
            for _ in range(2):
                rl = build(name)
                res = rl.run(lock_iters)
                runs.append((res.mean_metrics, [t.clone() for t in
                                                leaves(rl.params)]))
                del rl
            (ma, pa), (mb, pb) = runs
            check(ma == mb, f"{name}: same-seed metrics {ma} != {mb}")
            diff = [i for i, (x, y) in enumerate(zip(pa, pb))
                    if not torch.equal(x, y)]
            check(not diff, f"{name}: same-seed parameter leaves {diff} "
                  "differ")
            del runs, pa, pb
    finally:
        torch.backends.cudnn.deterministic = False
    say("agents", f"(b) two same-seed ParallelRL runs of {lock_iters} "
        "iterations agree bitwise (every metric and parameter) for "
        + ", ".join(AGENT_NAMES))

    path = {k: 0 for k in ops.launches}
    for name in AGENT_NAMES:
        rl = build(name)
        rl.run(warmup)
        before = [t.clone() for t in leaves(rl.params)]
        ops.reset_launches()
        res = rl.run(iters)
        counts = dict(ops.launches)
        want = {k: 0 for k in counts}
        if name.startswith("lagged"):
            want["nstep_returns"] = iters
        check(counts == want, f"{name}: launches {counts}, expected {want}")
        for k, v in counts.items():
            path[k] += v
        m = res.mean_metrics
        check(all(math.isfinite(v) for v in m.values()),
              f"{name}: non-finite metrics {m}")
        changed = max((a - b).abs().max().item() for a, b in
                      zip(before, leaves(rl.params)))
        check(changed > 0, f"{name}: the parameters did not change")
        t_max = rl.agent.hp.t_max
        iter_ms = 1e3 * n_envs * t_max / res.timesteps_per_sec
        extra = ""
        if name == "dqn":
            buf = rl.agent_state["replay"]
            extra = (f"; replay buffer of {replay_capacity} transitions "
                     f"({tuple(buf['obs'].shape[1:])} {buf['obs'].dtype} obs "
                     f"and next_obs): {replay.replay_nbytes(buf)} bytes on "
                     f"the card, {buf['size']} filled")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rl.run(window)
            torch.cuda.synchronize()
        busy_ms, by_name = device_window(prof, window)
        classes = {}
        for k, (ms, n) in by_name.items():
            row = classes.setdefault(kernel_class(k), [0.0, 0.0])
            row[0] += ms
            row[1] += n
        say("agents", f"(b) {name}: {iters} iterations of {n_envs}x{t_max} "
            f"after {warmup} warm-up, launches K1 {counts['nstep_returns']} "
            f"K2 {counts['vtrace_returns']}; {res.timesteps_per_sec:.1f} "
            f"timesteps/s, {iter_ms:.2f} ms an iteration; mean loss "
            f"{m['loss']:.4f}, reward/iter {m['reward_sum']:+.3f}; largest "
            f"parameter change {changed:.3g}{extra}; profiler window of "
            f"{window}: device busy {busy_ms:.3f} ms an iteration "
            f"({100 * busy_ms / iter_ms:.1f}% of the unprofiled "
            f"{iter_ms:.2f} ms), {sum(n for _, n in by_name.values()):.0f} "
            "device activities an iteration; by class (ms, launches an "
            "iteration): " + "; ".join(
                f"{k} {ms:.3f} x{n:.0f}" for k, (ms, n) in
                sorted(classes.items(), key=lambda kv: -kv[1][0]))
            + f" ({card})")
        del rl
        if dev != "cpu":
            torch.cuda.empty_cache()

    # (c) the paper's Table-1 protocol on the trained PAAC parameters
    agent, params = trained
    env = envs.FrameStack(envs.AtariLike(n_envs, device=dev), 4)
    t0 = time.perf_counter()
    ev = core.evaluate(agent.act_fn(), env, params,
                       torch.Generator(device=dev).manual_seed(SEED),
                       n_runs=30, n_actor_seeds=3, max_steps=eval_steps)
    wall = time.perf_counter() - t0
    check(len(ev["per_seed"]) == 3
          and all(math.isfinite(v) for v in ev["per_seed"])
          and ev["best_of_k"] >= ev["mean"], f"evaluate: {ev}")
    say("agents", f"(c) evaluate, greedy, 3 seeds x 30 runs, max_steps "
        f"{eval_steps}, on FrameStack(AtariLike({n_envs})) with the "
        f"training phase's paac_nature parameters: best_of_k "
        f"{ev['best_of_k']:.4f}, mean {ev['mean']:.4f}, per_seed "
        f"{[round(v, 4) for v in ev['per_seed']]}; {wall:.2f} s ({card})")

    # (d) the trainer itself: its three legs
    base = ["--arch", "paac_vector", "--n-envs", "32", "--t-max", "5",
            "--iterations", str(cli_iters), "--device", str(dev)]
    legs = (("sync PAAC", [], "nstep_returns"),
            ("--pipeline", ["--pipeline"], "vtrace_returns"),
            ("--algo dqn", ["--algo", "dqn"], None))
    cli = {k: 0 for k in ops.launches}
    for label, extra, kernel in legs:
        ops.reset_launches()
        res = train.main(base + extra)
        counts = dict(ops.launches)
        want = {k: cli_iters if k == kernel else 0 for k in counts}
        check(counts == want, f"train {label}: launches {counts}, expected "
              f"{want}")
        check(len(res) == 1 and res[0].steps == cli_iters * 32 * 5
              and all(math.isfinite(v) for v in res[0].mean_metrics.values()),
              f"train {label}: {res}")
        for k, v in counts.items():
            cli[k] += v
        say("agents", f"(d) python -m repro_torch.launch.train "
            f"{' '.join(base + extra)}: {res[0].steps} steps, launches K1 "
            f"{counts['nstep_returns']} K2 {counts['vtrace_returns']}, "
            f"{res[0].timesteps_per_sec:.1f} timesteps/s (first run included),"
            f" reward/iter {res[0].mean_metrics['reward_sum']:+.3f} ({card})")

    # (e) the paper's stability argument, the order reported
    spec = importlib.util.spec_from_file_location(
        "compare_baselines_torch",
        Path(__file__).resolve().parent / "examples"
        / "compare_baselines_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = time.perf_counter()
    scores = example.run(iters=compare_iters, device=dev)
    check(len(scores) == 4 and all(math.isfinite(v) for v in scores.values()),
          f"compare_baselines_torch: {scores}")
    say("agents", f"(e) examples/compare_baselines_torch.py at "
        f"{compare_iters} iterations on Catch(32), reward an iteration over "
        "40 more (best first): " + ", ".join(
            f"{k} {v:+.3f}" for k, v in
            sorted(scores.items(), key=lambda kv: -kv[1]))
        + f"; {time.perf_counter() - t0:.1f} s")
    return ({k: v for k, v in path.items() if v},
            {k: v for k, v in cli.items() if v})


MODEL_CASES = (  # (arch, config changes, prompt length, prefill, decode kernel)
    ("qwen2-7b", {}, 37, "flash_attention", "decode_attention"),
    ("minicpm3-4b", {"mla_absorb": True}, 37, "flash_attention",
     "mla_decode_attention"),
    ("minicpm3-4b", {"mla_absorb": False}, 37, "flash_attention", None),
    ("mamba2-370m", {}, 64, "ssd_scan", None),  # two chunks of 32
)


def phase_model(torch, np, configs, models, ops, tree, dev="cuda"):
    """Reduced qwen2-7b, minicpm3-4b (absorbed and naive decode) and
    mamba2-370m, fp32: CPU (plain versions) against the card (kernels),
    prefill and four decode steps with per-row and scalar positions."""
    for arch, change, S, pre, dec in MODEL_CASES:
        cfg = configs.get_config(arch).reduced().replace(**change)
        cpu = models.init_policy(
            cfg, generator=torch.Generator().manual_seed(SEED), device="cpu")
        gpu = tree.tree_map(lambda t: t.to(dev), cpu)
        rng = np.random.default_rng(SEED)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
        ops.reset_launches()
        lc, _, cache_c = models.policy_prefill(cpu, cfg, toks, max_len=S + 11)
        lg, _, cache_g = models.policy_prefill(gpu, cfg, toks.to(dev),
                                               max_len=S + 11)
        worst = (lc - lg.cpu()).abs().max().item()
        steps = [torch.tensor([S, S + 3], dtype=torch.int32), S + 4, S + 5,
                 torch.tensor([S + 6, S + 1], dtype=torch.int32)]
        for pos in steps:
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
            pos_g = pos.to(dev) if isinstance(pos, torch.Tensor) else pos
            lc, _, cache_c = models.policy_decode(cpu, cfg, cache_c, tok, pos)
            lg, _, cache_g = models.policy_decode(gpu, cfg, cache_g,
                                                  tok.to(dev), pos_g)
            worst = max(worst, (lc - lg.cpu()).abs().max().item())
        counts = dict(ops.launches)
        L = cfg.num_layers
        want = {name: 0 for name in counts}
        want[pre] = L
        if dec:
            want[dec] = L * len(steps)
        check(counts == want, f"reduced {arch} {change}: launches {counts}, "
              f"expected {want}")
        check(worst <= MODEL_ATOL, f"reduced {arch} {change} logits: card vs "
              f"CPU {worst:.3g}")
        say("model", f"reduced {arch} {change} fp32 (L={L} d={cfg.d_model}): "
            f"prefill of {S} + 4 decode steps (per-row and scalar pos), card "
            f"vs CPU max |dlogit| {worst:.3g} <= {MODEL_ATOL}; launches "
            + ", ".join(f"{k} {v}" for k, v in counts.items() if v))


SERVING_CELLS = (
    {"arch": "qwen2-7b", "change": {},
     "full": {"num_layers": 28, "d_model": 3584, "num_heads": 28,
              "num_kv_heads": 4, "head_dim": 128, "param_dtype": "bfloat16"},
     "prompt_lens": (128, 200, 333, 512), "prefill": "flash_attention",
     "decode": "decode_attention"},
    {"arch": "minicpm3-4b", "change": {"mla_absorb": True},
     "full": {"num_layers": 62, "d_model": 2560, "num_heads": 40,
              "q_lora_rank": 768, "kv_lora_rank": 256, "qk_nope_dim": 64,
              "qk_rope_dim": 32, "v_head_dim": 64, "d_ff": 6400,
              "param_dtype": "bfloat16"},
     "prompt_lens": (128, 200, 333, 512), "prefill": "flash_attention",
     "decode": "mla_decode_attention"},
    {"arch": "mamba2-370m", "change": {},
     "full": {"num_layers": 48, "d_model": 1024, "ssm_state": 128,
              "ssm_head_dim": 64, "ssm_expand": 2, "ssm_chunk": 128,
              "param_dtype": "bfloat16"},
     # whole 128-token chunks: a longer prompt must be a multiple
     "prompt_lens": (128, 256, 384, 512), "prefill": "ssd_scan",
     "decode": None},
)


def phase_serving(torch, np, configs, models, ops, serve, serving, tree,
                  card, cell, dev="cuda"):
    """One serving cell at full width and depth: the continuous entry point
    on 8 requests over 4 slots, a solo rerun, a profiled decode step and the
    lockstep demo. Returns the launch counts of the continuous run."""
    from repro_torch.pipeline.queue import TrajectoryQueue

    arch = cell["arch"]
    cfg = configs.get_config(arch).replace(**cell["change"])
    check(all(getattr(cfg, k) == v for k, v in cell["full"].items()),
          f"not the full {arch} config: {cfg}")
    L = cfg.num_layers
    pre, dec = cell["prefill"], cell["decode"]
    t0 = time.perf_counter()
    params = models.init_policy(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.tree_leaves(params))
    say("serving", f"{arch} full size {cell['change'] or ''}: "
        f"{n_params / 1e9:.2f} B parameters (bf16) initialised on the card "
        f"from seed {SEED} in {time.perf_counter() - t0:.1f} s")

    def expected(n_prefill, n_steps):
        want = {name: 0 for name in ops.launches}
        want[pre] = L * n_prefill
        if dec:
            want[dec] = L * n_steps
        return want

    slots, prompt_lens, gen_range = 4, cell["prompt_lens"], (16, 32)
    max_len = max(prompt_lens) + gen_range[1]
    kw = dict(slots=slots, max_len=max_len, prompt_lens=prompt_lens,
              gen_range=gen_range, rate_hz=0.0, device=dev)
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
    check(counts == expected(res["admitted"], res["steps"]),
          f"{arch}: launches {counts} for {res['admitted']} prefills and "
          f"{res['steps']} decode steps of {L} layers; expected "
          f"{expected(res['admitted'], res['steps'])}")
    say("serving", f"{arch} continuous: 8/8 requests done, {res['tokens']} "
        f"tokens, {res['steps']} decode steps, launches {pre} {counts[pre]} "
        f"(= {L} x {res['admitted']} prefills)"
        + (f" {dec} {counts[dec]} (= {L} x {res['steps']} steps)" if dec else
           " (decode runs no kernel)") + ", every other kernel 0")
    say("serving", f"{arch} bf16, {slots} slots, burst of 8: "
        f"{res['tok_s']:.1f} tok/s aggregate, latency p50 {res['p50_ms']:.1f} ms "
        f"p99 {res['p99_ms']:.1f} ms, wall {res['wall_s']:.3f} s ({card})")

    probe = max(reqs, key=lambda r: (r.t_admit, r.rid))  # joined mid-flight
    solo = serving.Request(rid=probe.rid, prompt=probe.prompt.copy(),
                           max_new_tokens=probe.max_new_tokens, seed=probe.seed)
    q = TrajectoryQueue(depth=2)
    q.put(solo)
    q.producer_done()
    engine = serving.DecodeEngine(cfg, params, max_slots=slots,
                                  max_len=max_len, device=dev)
    serving.Scheduler(engine, q, continuous=False).run()
    check(solo.status == "done" and np.array_equal(solo.tokens, probe.tokens),
          f"{arch} request {probe.rid}: continuous {probe.tokens.tolist()} != "
          f"solo {None if solo.tokens is None else solo.tokens.tolist()}")
    say("serving", f"{arch} request {probe.rid} (prompt {len(probe.prompt)}, "
        f"{probe.max_new_tokens} tokens) rerun solo on a fresh {slots}-slot "
        "engine: bitwise equal")
    del engine

    wall_ms, busy_ms, summed_ms, top, by_name = profile_decode(
        torch, np, serving, cfg, params, slots, max_len, dev=dev)
    busy = (f"device busy {busy_ms:.2f} ms a step ({100 * busy_ms / wall_ms:.0f}%"
            " of the unprofiled step; the sum of self device times over "
            f"key_averages, which counts a kernel under its op too, gives "
            f"{summed_ms:.2f} ms)" if busy_ms > 0 else
            "device time not measured (the profiler saw no device activity)")
    say("serving", f"{arch} decode step, {slots} rows at pos 256-264, "
        f"torch.profiler window of 8 steps: wall {wall_ms:.2f} ms a step "
        f"without the profiler, {busy}; top kernels (ms a step, launches a "
        "step): " + "; ".join(f"{k[:60]} {ms:.3f} x{n:.0f}"
                              for k, (ms, n) in top))
    if dec and busy_ms > 0:
        k_ms, k_n = kernel_time(by_name, dec)
        say("serving", f"{arch} decode step: {dec} {k_ms:.3f} ms a step "
            f"x{k_n:.0f} ({100 * k_ms / busy_ms:.1f}% of the busy "
            f"{busy_ms:.2f} ms)")
    p_wall, p_busy, p_by = profile_prefill(
        torch, np, serving, cfg, params, slots, max_len,
        prompt_len=max(prompt_lens), dev=dev)
    k_ms, k_n = kernel_time(p_by, pre)
    say("serving", f"{arch} prefill of {max(prompt_lens)} tokens through "
        f"DecodeEngine.admit, torch.profiler window of 3: wall "
        f"{p_wall:.2f} ms without the profiler, device busy {p_busy:.2f} ms; "
        f"{pre} {k_ms:.3f} ms x{k_n:.0f} "
        f"({100 * k_ms / max(p_busy, 1e-9):.1f}% of the busy time)")

    _, prompt_gen, decode_gen = serve.demo_generators(SEED, dev)
    ops.reset_launches()
    lock = serve.run_lockstep(cfg, params, batch=4, prompt_len=128, gen=8,
                              prompt_gen=prompt_gen, decode_gen=decode_gen,
                              device=dev)
    lock_counts = dict(ops.launches)
    check(lock["logits_finite"], f"{arch} lockstep prefill logits not finite")
    check(lock["tokens"].shape == (4, 9),
          f"{arch} lockstep tokens {lock['tokens'].shape}")
    check(bool(((lock["tokens"] >= 0) & (lock["tokens"] < cfg.vocab_size)).all()),
          f"{arch} lockstep token out of range")
    check(lock_counts == expected(1, 8),
          f"{arch} lockstep launches {lock_counts}, expected {expected(1, 8)}")
    say("serving", f"{arch} lockstep demo (scalar pos): batch 4, prompt 128, 8 "
        f"steps, launches {lock_counts}; prefill "
        f"{lock['prefill_s'] * 1e3:.1f} ms, decode "
        f"{lock['decode_s'] * 1e3:.1f} ms")
    del params
    torch.cuda.empty_cache()
    return counts


def profile_decode(torch, np, serving, cfg, params, slots, max_len,
                   steps: int = 8, dev="cuda"):
    """Decode step time with and without torch.profiler, over a steady
    window of ``steps`` steps with every slot leased: (wall ms a step,
    device-busy ms a step, the sum of self device times over
    ``key_averages`` that earlier runs reported as busy, top kernels by
    device time)."""
    from torch.profiler import ProfilerActivity, profile

    engine = serving.DecodeEngine(cfg, params, max_slots=slots,
                                  max_len=max_len, device=dev)
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
    summed_ms = sum(e.self_device_time_total
                    for e in prof.key_averages()) / steps / 1e3
    busy_ms, by_name = device_window(prof, steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return wall_ms, busy_ms, summed_ms, top, by_name


def profile_prefill(torch, np, serving, cfg, params, slots, max_len,
                    prompt_len: int = 512, reps: int = 3, dev="cuda"):
    """One prompt of ``prompt_len`` tokens prefilled through
    ``DecodeEngine.admit`` (the model's prefill, the first token, the cache
    write), ``reps`` times after a warm-up: (wall ms a prefill without the
    profiler, device-busy ms a prefill, {name: [ms, launches]} a prefill)."""
    from torch.profiler import ProfilerActivity, profile

    engine = serving.DecodeEngine(cfg, params, max_slots=slots,
                                  max_len=max_len, device=dev)
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size, prompt_len)
    engine.admit(0, prompt, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.admit(0, prompt, seed=0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            engine.admit(0, prompt, seed=0)
        torch.cuda.synchronize()
    busy_ms, by_name = device_window(prof, reps)
    return wall_ms, busy_ms, by_name


class FrameEnv:
    """A stand-in for one ALE emulator behind ``HostEnvPool``: 84x84x4 fp32
    frames made with numpy from the env's own ``RandomState``, reward 1
    when action == state mod 3 and an episode every 10 steps (the rule of
    ``benchmarks/fig2_time_split.py``'s external env), 6 actions; each step
    costs ``delay`` seconds of ``time.sleep``, which releases the GIL as
    an emulator's native step does."""

    SHAPE = (84, 84, 4)

    def __init__(self, seed: int, delay: float):
        import numpy as np

        self.rng = np.random.RandomState(seed)
        self.delay = delay
        self.state = 0

    def _obs(self):
        return self.rng.random_sample(self.SHAPE).astype("float32")

    def reset(self):
        self.state = int(self.rng.randint(0, 100))
        return self._obs()

    def step(self, action):
        if self.delay:
            time.sleep(self.delay)
        reward = 1.0 if int(action) == self.state % 3 else 0.0
        self.state += 1
        return self._obs(), reward, self.state % 10 == 0, {}


# the keys of a heartbeat line of repro/telemetry/hub.py, with the
# pipeline's two gauges
HEARTBEAT_KEYS = {"time_unix", "uptime_s", "steps", "steps_per_s_ema",
                  "span_drops", "actor_last_activity_s", "counters",
                  "queue_depth", "staleness"}


def phase_host(torch, np, configs, core, envs, A, optim, pipeline,
               paper_atari, ops, tree, train, card, dev="cuda", n_envs=32,
               n_workers=8, warmup=10, iters=100, lock_iters=10, window=10,
               cli_iters=50, env_spin=2000):
    """The paper's host env plane: ``ParallelRL`` and ``PipelinedRL`` on a
    ``HostEnvPool`` of ``n_envs`` stand-in emulators over ``n_workers``
    threads, paac_nature at full size in fp32; the bitwise pins; the
    trainer's ``--host-env`` legs; the aliasing checks. Returns the launch
    counts of the timed sync runs, of the timed pipelined runs and of the
    trainer's legs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.pipeline.actor import to_device

    t_phase = time.perf_counter()
    leaves = tree.tree_leaves
    inf = float("inf")
    t_max = 5
    lr = 0.0007 * n_envs
    frame_bytes = n_envs * int(np.prod(FrameEnv.SHAPE)) * 4
    cfg = configs.get_config("paac_nature").replace(
        obs_shape=FrameEnv.SHAPE, num_actions=6)

    def pool(delay):
        return envs.HostEnvPool([lambda s=i: FrameEnv(s, delay)
                                 for i in range(n_envs)],
                                n_workers=n_workers,
                                obs_shape=FrameEnv.SHAPE, device=dev)

    def agent():
        return A.PAACAgent(cfg, A.PAACConfig(gamma=0.99, entropy_beta=0.01,
                                             t_max=t_max))

    kw = dict(optimizer="rmsprop", lr_schedule=optim.constant(lr), seed=SEED,
              device=dev)

    def sync(p):
        return core.ParallelRL(p, agent(), **kw)

    def piped(p, **cfg_kw):
        return pipeline.PipelinedRL(p, agent(),
                                    pipeline=configs.PipelineConfig(**cfg_kw),
                                    **kw)

    def run_checked(label, rl, n, want):
        """``rl.run(n)`` with the counts set to 0 just before it: the
        launches must be ``want``, the metrics finite, the parameters
        changed."""
        before = [t.clone() for t in leaves(rl.params)]
        ops.reset_launches()
        res = rl.run(n)
        counts = dict(ops.launches)
        expect = {k: want.get(k, 0) for k in counts}
        check(counts == expect, f"{label}: launches {counts}, expected "
              f"{expect}")
        check(all(math.isfinite(v) for v in res.mean_metrics.values()),
              f"{label}: non-finite metrics {res.mean_metrics}")
        changed = max((a - b).abs().max().item() for a, b in
                      zip(before, leaves(rl.params)))
        check(changed > 0, f"{label}: the parameters did not change")
        return res, counts

    def busy_window(rl):
        """(device-busy ms, H2D ms, H2D copies, device activities), each an
        iteration, of a profiler window."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rl.run(window)
            torch.cuda.synchronize()
        busy_ms, by_name = device_window(prof, window)
        h2d = [row for name, row in by_name.items() if "HtoD" in name]
        return (busy_ms, sum(r[0] for r in h2d), sum(r[1] for r in h2d),
                sum(r[1] for r in by_name.values()))

    with pool(0.0) as p:
        n_params = sum(t.numel() for t in leaves(sync(p).params))
    say("host", f"paac_nature ({n_params / 1e6:.2f} M parameters, fp32) on "
        f"a HostEnvPool of {n_envs} stand-in emulators (84x84x4 fp32 "
        f"frames, 6 actions) over {n_workers} worker threads, t_max "
        f"{t_max}, RMSProp lr {lr:g}; page-locked H2D {frame_bytes} B an "
        f"acting step, {t_max * frame_bytes} B of frames (+ {frame_bytes} B "
        "bootstrap) at the update")

    # (a) the synchronous host ParallelRL at delay 0, then calibrated
    sync_counts = {k: 0 for k in ops.launches}

    def timed_sync(delay):
        with pool(delay) as p:
            rl = sync(p)
            collect_s = []
            real_collect = rl._collect_host

            def collect(*a, **k):
                t0 = time.perf_counter()
                try:
                    return real_collect(*a, **k)
                finally:
                    collect_s.append(time.perf_counter() - t0)

            rl._collect_host = collect
            rl.run(warmup)
            collect_s.clear()
            res, counts = run_checked(f"sync host, delay {delay}", rl, iters,
                                      {"nstep_returns": iters})
            for k, v in counts.items():
                sync_counts[k] += v
            iter_ms = 1e3 * n_envs * t_max / res.timesteps_per_sec
            collect_ms = 1e3 * sum(collect_s) / len(collect_s)
            # the update alone, at the state the run reached: the staged
            # trajectory's copy to the card and the learner step
            traj, last = rl._staging.traj, rl._staging.last_obs
            for i in range(21):
                if i == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                rl._update_step(rl.params, rl.opt_state,
                                *to_device(traj, last, rl.device), 0)
            torch.cuda.synchronize()
            update_ms = (time.perf_counter() - t0) / 20 * 1e3
            busy_ms, h2d_ms, h2d_n, acts = busy_window(rl)
            if delay == 0:
                layers = step_layers(rl)
        m = res.mean_metrics
        say("host", f"(a) sync ParallelRL, delay {1e3 * delay:.1f} ms a "
            f"step: {iters} iterations after {warmup} warm-up, K1 "
            f"{counts['nstep_returns']} K2 {counts['vtrace_returns']}; "
            f"{res.timesteps_per_sec:.1f} timesteps/s, {iter_ms:.2f} ms an "
            f"iteration = collect {collect_ms:.2f} ms "
            f"({100 * collect_ms / iter_ms:.1f}%) + update "
            f"{iter_ms - collect_ms:.2f} ms; the update alone (H2D + "
            f"learner step) {update_ms:.2f} ms; mean loss {m['loss']:.4f}, "
            f"entropy {m['entropy']:.4f}, rho_mean {m['rho_mean']:.6f}; "
            f"profiler window of {window}: device busy {busy_ms:.3f} ms an "
            f"iteration ({100 * busy_ms / iter_ms:.1f}%), {acts:.0f} device "
            f"activities, H2D copies {h2d_ms:.3f} ms x{h2d_n:.0f} "
            f"({card})")
        if delay == 0:
            say("host", "(a) one acting step's layers alone, at the state "
                "the run reached (host ms a call): " + "; ".join(
                    f"{k} {v:.3f}" for k, v in layers.items()))
        return dict(tps=res.timesteps_per_sec, iter_ms=iter_ms,
                    update_ms=update_ms, busy=busy_ms / iter_ms)

    def step_layers(rl, n=20):
        """The layers of one step of ``collect_host``, each alone: the env
        workers' step (on the pool's workers and on one), the copy of the
        frames into the staging set, their H2D, and the act step with its
        packed read-back (the acting sync)."""
        p, s, dev_ = rl.env, rl._staging, rl.device
        actions = np.zeros(n_envs, np.int64)
        gen = torch.Generator(device=dev_).manual_seed(SEED)
        obs = s.traj.obs[0].to(dev_)
        with envs.HostEnvPool([lambda i=i: FrameEnv(i, 0.0)
                               for i in range(n_envs)], n_workers=1,
                              obs_shape=FrameEnv.SHAPE, device=dev) as one:
            one.reset()

            def h2d():
                s.traj.obs[0].to(dev_, non_blocking=True)
                torch.cuda.synchronize()

            def act():
                a, v, lp = rl._act(rl.params, obs, gen)
                torch.stack([a.float(), v.float(), lp.float()]).cpu()

            fns = {f"env step ({n_workers} workers)":
                   lambda: p.step_host(actions),
                   "env step (1 worker)": lambda: one.step_host(actions),
                   "staging copy": lambda: np.copyto(s.np_traj.obs[1],
                                                     p._obs),
                   "H2D of the frames": h2d,
                   "act step + packed read-back": act}
            out = {}
            for k, fn in fns.items():
                fn()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                out[k] = (time.perf_counter() - t0) / n * 1e3
        return out

    rows = {"sync, delay 0": timed_sync(0.0)}
    sync_tps = rows["sync, delay 0"]["tps"]
    envs_a_worker = -(-n_envs // n_workers)
    # the update's wall spread over the rollout's t_max steps and the envs
    # each worker steps in turn, rounded up to 0.1 ms: the envs then take
    # about as long as the update (the paper's ~50% env time)
    delay = math.ceil(rows["sync, delay 0"]["update_ms"]
                      / (t_max * envs_a_worker) * 10) / 1e4
    say("host", f"calibrated delay: update "
        f"{rows['sync, delay 0']['update_ms']:.2f} ms / ({t_max} steps x "
        f"{envs_a_worker} envs a worker), rounded up to 0.1 ms: "
        f"{1e3 * delay:.1f} ms a step")
    rows[f"sync, delay {1e3 * delay:.1f}"] = timed_sync(delay)

    # (b) bitwise pins, cuDNN deterministic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        runs = []
        for _ in range(2):
            with pool(0.0) as p:
                rl = sync(p)
                runs.append((rl.run(lock_iters), rl))
        check_bitwise(torch, tree, *runs[0], *runs[1],
                      "two same-seed sync host runs")
        with pool(0.0) as p:
            lock = piped(p, queue_depth=1, lockstep=True, rho_bar=inf,
                         c_bar=inf)
            lock_res, counts = run_checked(
                "lockstep host plane", lock, lock_iters,
                {"nstep_returns": lock_iters})
        check(lock.staleness == [0.0] * lock_iters,
              f"lockstep host staleness {lock.staleness}")
        check_bitwise(torch, tree, lock_res, lock, *runs[0],
                      "lockstep host plane vs sync host ParallelRL")
        dev_sync = paper_atari.build("paac_nature", n_envs, SEED, dev)
        forced = paper_atari.build(
            "paac_nature", n_envs, SEED, dev,
            configs.PipelineConfig(queue_depth=1, lockstep=True, rho_bar=inf,
                                   c_bar=inf, rollout_plane="host"))
        check(forced._plane == "host", f"plane {forced._plane}")
        check_bitwise(torch, tree, forced.run(lock_iters), forced,
                      dev_sync.run(lock_iters), dev_sync,
                      "forced host plane on FrameStack(AtariLike) vs "
                      "ParallelRL")
        del runs, rl, lock, dev_sync, forced
    finally:
        torch.backends.cudnn.deterministic = False
    say("host", f"(b) bitwise, cuDNN deterministic, {lock_iters} "
        "iterations each: two same-seed sync host runs; lockstep "
        "PipelinedRL (depth 1, rho_bar = c_bar = inf) on the same pool "
        f"recipe equals them (K1 {counts['nstep_returns']}, K2 "
        f"{counts['vtrace_returns']}); the forced host plane on "
        f"FrameStack(AtariLike({n_envs})) equals ParallelRL on it")

    # (c) the pipelined host plane at clips 1, at both delays
    pipe_counts = {k: 0 for k in ops.launches}
    for d in (0.0, delay):
        for label, n_act, depth in (("one actor", 1, 2),
                                    (f"four actors of {n_envs // 4} envs", 4,
                                     4)):
            with pool(d) as p:
                rl = piped(p, queue_depth=depth, num_actors=n_act)
                rl.run(warmup)
                res, counts = run_checked(f"{label}, delay {d}", rl, iters,
                                          {"vtrace_returns": iters})
                for k, v in counts.items():
                    pipe_counts[k] += v
                want = [(a, s) for a in range(n_act)
                        for s in range(iters // n_act)]
                check(sorted(rl.learned_ids) == want,
                      f"{label}: an (actor_id, seq) was dropped or learned "
                      "twice")
                # one actor runs at most depth rollouts ahead of the
                # learner, plus the one it is collecting; several contend
                # for the queue's free slots in no fixed order, so their
                # staleness has no such bound (the reference's neither)
                stale = max(rl.staleness)
                check(n_act > 1 or stale <= depth + 1,
                      f"{label}: staleness {stale} > {depth + 1}")
                spans = span_means(rl.telemetry)
                update_ms, _ = span_stat(rl.telemetry, "learner",
                                         "learner.update")
                busy_ms, h2d_ms, h2d_n, acts = busy_window(rl)
            per_iter = rl._steps_per_iter
            iter_ms = 1e3 * per_iter / res.timesteps_per_sec
            wall_s = iters * iter_ms / 1e3
            m = res.mean_metrics
            row = rows[f"{'one actor' if n_act == 1 else 'four actors'}, "
                       f"delay {1e3 * d:.1f}"] = dict(
                tps=res.timesteps_per_sec, iter_ms=iter_ms,
                busy=busy_ms / iter_ms, update_ms=update_ms,
                actor_idle=res.actor_idle_s / (n_act * wall_s),
                learner_idle=res.learner_idle_s / wall_s)
            say("host", f"(c) PipelinedRL host plane, {label}, depth "
                f"{depth}, clips 1, delay {1e3 * d:.1f} ms: {iters} updates "
                f"after {warmup} warm-up, K1 {counts['nstep_returns']} K2 "
                f"{counts['vtrace_returns']}; {res.timesteps_per_sec:.1f} "
                f"timesteps/s, {iter_ms:.2f} ms an update of {per_iter} "
                f"timesteps; staleness mean {m['staleness']:.3f} max "
                f"{stale:.0f}, rho_mean {m['rho_mean']:.4f}; "
                f"actor idle {100 * row['actor_idle']:.1f}%, learner idle "
                f"{100 * row['learner_idle']:.1f}%; profiler window of "
                f"{window}: device busy {busy_ms:.3f} ms an update "
                f"({100 * row['busy']:.1f}%), {acts:.0f} device activities, "
                f"H2D {h2d_ms:.3f} ms x{h2d_n:.0f}; mean host ms of each "
                f"span (track, stage, count): {spans} ({card})")
            del rl
    say("host", "timesteps/s: " + ", ".join(
        f"{k} {r['tps']:.1f} (busy {100 * r['busy']:.1f}%)"
        for k, r in rows.items()))

    # (f) the GIL's hand-off: the four-actor cell at delay 0 again with a
    # switch interval of 0.5 ms (a thread woken from a wait gets the GIL
    # within it), then the default 5 ms restored
    default_switch = sys.getswitchinterval()
    sys.setswitchinterval(0.0005)
    try:
        with pool(0.0) as p:
            rl = piped(p, queue_depth=4, num_actors=4)
            rl.run(warmup)
            res, _ = run_checked("four actors, switch interval 0.5 ms", rl,
                                 iters, {"vtrace_returns": iters})
            update_ms, n_upd = span_stat(rl.telemetry, "learner",
                                         "learner.update")
            del rl
    finally:
        sys.setswitchinterval(default_switch)
    base = rows["four actors, delay 0.0"]
    say("host", f"(f) four actors, depth 4, delay 0, "
        f"sys.setswitchinterval(0.0005): {res.timesteps_per_sec:.1f} "
        f"timesteps/s ({res.timesteps_per_sec / base['tps']:.2f}x the "
        f"default {1e3 * default_switch:g} ms interval's "
        f"{base['tps']:.1f}, {res.timesteps_per_sec / sync_tps:.2f}x sync), "
        f"learner update span {update_ms:.2f} ms x{n_upd} against "
        f"{base['update_ms']:.2f} ms at the default; the interval restored "
        f"to {1e3 * sys.getswitchinterval():g} ms ({card})")

    # (d) the reference trainer with --host-env (PyBoundEnv, GIL-held spin)
    spec = envs.py_bound_spec(n_envs, obs_dim=16, spin=env_spin,
                              n_workers=min(8, n_envs), device=dev)
    step_ms = {}
    for n_w in (spec.n_workers, 1):
        with envs.HostEnvPool([lambda a=a: spec.env_fn(*a)
                               for a in spec.env_args], n_workers=n_w,
                              obs_shape=spec.obs_shape, device=dev) as p:
            p.reset()
            acts = np.zeros(n_envs, np.int64)
            p.step_host(acts)
            t0 = time.perf_counter()
            for _ in range(20):
                p.step_host(acts)
            step_ms[n_w] = (time.perf_counter() - t0) / 20 * 1e3
    say("host", f"(d) PyBoundEnv spin {env_spin}: one step_host of {n_envs} "
        f"envs takes {step_ms[spec.n_workers]:.3f} ms on {spec.n_workers} "
        f"workers and {step_ms[1]:.3f} ms on 1 "
        f"({step_ms[1] / step_ms[spec.n_workers]:.2f}x): the workers "
        "serialise on the GIL")
    base = ["--arch", "paac_vector", "--host-env", "--n-envs", str(n_envs),
            "--t-max", str(t_max), "--iterations", str(cli_iters),
            "--env-spin", str(env_spin), "--device", str(dev)]
    cli = {k: 0 for k in ops.launches}
    with tempfile.TemporaryDirectory() as tmp:
        hb = os.path.join(tmp, "hb.jsonl")
        legs = (("sync", [], "nstep_returns"),
                ("--pipeline", ["--pipeline"], "vtrace_returns"),
                ("--pipeline + observers", ["--pipeline", "--metrics-jsonl",
                                            hb, "--stall-timeout", "30"],
                 "vtrace_returns"))
        for label, extra, kernel in legs:
            ops.reset_launches()
            res = train.main(base + extra)
            counts = dict(ops.launches)
            want = {k: cli_iters if k == kernel else 0 for k in counts}
            check(counts == want, f"train --host-env {label}: launches "
                  f"{counts}, expected {want}")
            check(len(res) == 1
                  and res[0].steps == cli_iters * n_envs * t_max
                  and all(math.isfinite(v)
                          for v in res[0].mean_metrics.values()),
                  f"train --host-env {label}: {res}")
            for k, v in counts.items():
                cli[k] += v
            say("host", f"(d) python -m repro_torch.launch.train "
                f"{' '.join(base + extra[:1])}"
                f"{' --metrics-jsonl F --stall-timeout 30' if extra[1:] else ''}"
                f": {res[0].steps} steps, K1 {counts['nstep_returns']} K2 "
                f"{counts['vtrace_returns']}, {res[0].timesteps_per_sec:.1f} "
                f"timesteps/s (first run included), reward/iter "
                f"{res[0].mean_metrics['reward_sum']:+.3f} ({card})")
        with open(hb) as f:
            lines = [json.loads(x) for x in f if x.strip()]
    check(lines and all(set(x) == HEARTBEAT_KEYS for x in lines)
          and lines[-1]["steps"] == cli_iters * n_envs * t_max,
          f"heartbeat: {len(lines)} lines, keys "
          f"{sorted(set(lines[-1])) if lines else None}")
    say("host", f"(d) heartbeat: {len(lines)} lines, each with the "
        f"reference's keys; last steps {lines[-1]['steps']:.0f}, "
        f"steps_per_s_ema {lines[-1]['steps_per_s_ema']:.1f}")

    # (e) no aliasing on the card
    with pool(0.0) as p:
        p.reset()
        out = p.step(np.zeros(n_envs, np.int64))
        check(all(t.device.type == torch.device(dev).type for t in out),
              f"HostEnvPool.step() gave tensors off {dev}")
        snap = [t.clone() for t in out]
        p.step_host(np.ones(n_envs, np.int64))
        check(all(torch.equal(a, b) for a, b in zip(out, snap)),
              "a HostEnvPool.step() tensor changed at the next step_host")
        check(not torch.equal(out[0].cpu(), torch.from_numpy(p._obs)),
              "the next step_host wrote the same frames")
    real_release = pipeline.HostStagingRing.release

    def poisoned(self, s):
        for t in s.traj + (s.last_obs,):
            if t.dtype.is_floating_point:
                t.fill_(float("nan"))
        real_release(self, s)

    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for poison in (False, True):
            pipeline.HostStagingRing.release = (poisoned if poison
                                                else real_release)
            try:
                with pool(0.0) as p:
                    rl = piped(p, queue_depth=1, lockstep=True, rho_bar=inf,
                               c_bar=inf)
                    runs.append((rl.run(lock_iters), rl))
            finally:
                pipeline.HostStagingRing.release = real_release
        check(all(math.isfinite(v) for v in runs[1][0].mean_metrics.values()),
              f"NaN-poisoned release: {runs[1][0].mean_metrics}")
        check_bitwise(torch, tree, *runs[1], *runs[0],
                      "NaN-poisoned release vs a clean rerun")
    finally:
        torch.backends.cudnn.deterministic = False
    say("host", "(e) HostEnvPool.step() gives CUDA tensors that the next "
        "step_host leaves unchanged; staging sets overwritten with NaN the "
        f"moment release() hands them back: {lock_iters} lockstep updates "
        "finite and bitwise equal to a clean rerun; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return ({k: v for k, v in sync_counts.items() if v},
            {k: v for k, v in pipe_counts.items() if v},
            {k: v for k, v in cli.items() if v}, rows, delay)


def frame_spec(envs, np, n_envs: int, delay: float, n_workers: int, dev):
    """A picklable ``HostEnvSpec`` of ``n_envs`` ``FrameEnv``s: spawned
    workers rebuild it (``FrameEnv`` is a module-level class of this
    script, which a spawned child imports again as ``__mp_main__``)."""
    return envs.HostEnvSpec(env_fn=FrameEnv,
                            env_args=tuple((i, delay) for i in range(n_envs)),
                            n_workers=n_workers, obs_shape=FrameEnv.SHAPE,
                            obs_dtype=np.float32, device=str(dev))


def phase_host_process(torch, np, configs, envs, A, optim, pipeline, ops,
                       tree, train, card, sync_rows, delay, dev="cuda",
                       n_envs=32, n_workers=8, warmup=10, iters=100,
                       lock_iters=10, window=10, cli_iters=50, env_spin=2000,
                       sweep=(1, 2, 4, 8), sweep_iters=50):
    """The process actor plane (spawned workers over shared memory) in the
    host phase's setting: one worker at depth 2 and four of 8 envs at
    depth 4, at delay 0 and at the calibrated ``delay``, beside the
    synchronous rows ``sync_rows`` of ``phase_host``; 32 ``PyBoundEnv``s
    on 1, 2, 4 and 8 workers; lockstep ≡ the thread host plane bitwise;
    nothing left in /dev/shm; the trainer's ``--actor-backend process``
    leg. Returns the launch counts of the timed runs and of the trainer's
    leg."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    leaves = tree.tree_leaves
    inf = float("inf")
    t_max = 5
    lr = 0.0007 * n_envs
    cfg = configs.get_config("paac_nature").replace(
        obs_shape=FrameEnv.SHAPE, num_actions=6)

    def agent(c=cfg):
        return A.PAACAgent(c, A.PAACConfig(gamma=0.99, entropy_beta=0.01,
                                           t_max=t_max))

    def piped(env, c=cfg, lr=lr, **cfg_kw):
        cfg_kw.setdefault("actor_backend", "process")
        return pipeline.PipelinedRL(env, agent(c),
                                    pipeline=configs.PipelineConfig(**cfg_kw),
                                    optimizer="rmsprop",
                                    lr_schedule=optim.constant(lr), seed=SEED,
                                    device=dev)

    def shm_now():
        return set(os.listdir("/dev/shm"))

    def timed(rl, n_act, label, n_iters, free0, reserved0):
        """Warm-up, then ``n_iters`` updates with the counts set to 0 just
        before them; every (actor_id, seq) learned once; spans; then a
        profiler window of the parent's device work. ``free0`` and
        ``reserved0`` are the card's free and the parent's reserved bytes
        before the workers were spawned: what the card lost beyond the
        parent's own growth is the workers' (contexts and tensors).
        Returns the row."""
        t0 = time.perf_counter()
        rl.run(warmup)
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        child_mib = (free0 - torch.cuda.mem_get_info()[0]
                     - (torch.cuda.memory_reserved() - reserved0)) / 2**20
        quota = [n_iters // n_act + (1 if a < n_iters % n_act else 0)
                 for a in range(n_act)]
        before = [t.clone() for t in leaves(rl.params)]
        ops.reset_launches()
        res = rl.run(n_iters)
        counts = dict(ops.launches)
        want = {k: n_iters if k == "vtrace_returns" else 0 for k in counts}
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        check(all(math.isfinite(v) for v in res.mean_metrics.values()),
              f"{label}: non-finite metrics {res.mean_metrics}")
        check(max((a - b).abs().max().item() for a, b in
                  zip(before, leaves(rl.params))) > 0,
              f"{label}: the parameters did not change")
        check(sorted(rl.learned_ids) == [(a, q) for a in range(n_act)
                                         for q in range(quota[a])],
              f"{label}: an (actor_id, seq) was dropped or learned twice")
        hub, stale_max = rl.telemetry, max(rl.staleness)
        update_ms, _ = span_stat(hub, "learner", "learner.update")
        collect_ms, n_col = span_stat(hub, "worker", "collect")
        copy_ms, _ = span_stat(hub, "worker", "shm.copy")
        publish_ms, _ = span_stat(hub, "shm.publish", "shm.copy")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rl.run(window)
            torch.cuda.synchronize()
        busy_ms, by_name = device_window(prof, window)
        h2d = [row for name, row in by_name.items() if "HtoD" in name]
        # one payload's copy to the card, host-timed: from a worker's
        # pageable shm set, as the learner copies it, and from page-locked
        # copies of it (the workers are idle between runs)
        payload = list(rl._process_plane._workers[0].sets[0].traj) + [
            rl._process_plane._workers[0].sets[0].last_obs]
        payload_ms = {}
        for kind, src in (("pageable", payload),
                          ("page-locked", [t.pin_memory() for t in payload])):
            for i in range(21):
                if i == 1:
                    t0 = time.perf_counter()
                for t in src:
                    t.to(dev, non_blocking=True)
                torch.cuda.synchronize()
            payload_ms[kind] = (time.perf_counter() - t0) / 20 * 1e3
        del payload
        per_iter = rl._steps_per_iter
        iter_ms = 1e3 * per_iter / res.timesteps_per_sec
        wall_s = n_iters * iter_ms / 1e3
        m = res.mean_metrics
        return dict(
            tps=res.timesteps_per_sec, iter_ms=iter_ms, counts=counts,
            update_ms=update_ms, collect_ms=collect_ms, n_col=n_col,
            copy_ms=copy_ms, publish_ms=publish_ms,
            learner_idle=res.learner_idle_s / wall_s,
            actor_idle=res.actor_idle_s / (n_act * wall_s),
            stale_mean=m["staleness"], stale_max=stale_max,
            busy_ms=busy_ms, busy=busy_ms / iter_ms,
            h2d_ms=sum(r[0] for r in h2d), h2d_n=sum(r[1] for r in h2d),
            per_iter=per_iter, warm_s=warm_s, child_mib=child_mib / n_act,
            pageable_ms=payload_ms["pageable"],
            pinned_ms=payload_ms["page-locked"])

    say("host", f"process plane: paac_nature on HostEnvSpecs of {n_envs} "
        f"FrameEnvs, spawned workers (each its own interpreter and CUDA "
        f"context, acting on {dev}), shm staging and the shm param slot; "
        "the parent's learner through K2 at clips 1")
    path = {k: 0 for k in ops.launches}
    rows = {}
    for d in (0.0, delay):
        for label, n_act, depth in (("one worker", 1, 2),
                                    (f"four workers of {n_envs // 4} envs",
                                     4, 4)):
            spec = frame_spec(envs, np, n_envs, d, n_workers, dev)
            free0, reserved0 = (torch.cuda.mem_get_info()[0],
                                torch.cuda.memory_reserved())
            rl = piped(spec, queue_depth=depth, num_actors=n_act)
            try:
                r = timed(rl, n_act, f"process {label}, delay {d}", iters,
                          free0, reserved0)
                segs = rl._process_plane.segment_names()
                procs = [w.proc for w in rl._process_plane._workers]
            finally:
                rl.close()
            check(not any(p.is_alive() for p in procs),
                  f"process {label}: a worker outlived close()")
            check(not set(segs) & shm_now(),
                  f"process {label}: segments left in /dev/shm")
            for k, v in r["counts"].items():
                path[k] += v
            key = (f"{'one worker' if n_act == 1 else 'four workers'}, "
                   f"delay {1e3 * d:.1f}")
            rows[key] = r
            sync = sync_rows["sync, delay 0" if d == 0 else
                             f"sync, delay {1e3 * d:.1f}"]
            thread_key = (f"{'one actor' if n_act == 1 else 'four actors'}"
                          f", delay {1e3 * d:.1f}")
            thread = sync_rows.get(thread_key)
            say("host", f"(g) process plane, {label}, depth {depth}, clips "
                f"1, delay {1e3 * d:.1f} ms: the warm-up of {warmup} (the "
                f"workers' start, imports and first forwards included) "
                f"{r['warm_s']:.1f} s, "
                f"{r['child_mib']:.0f} MiB of the card a worker; {iters} "
                "updates, "
                f"K1 {r['counts']['nstep_returns']} K2 "
                f"{r['counts']['vtrace_returns']}; {r['tps']:.1f} "
                f"timesteps/s ({r['tps'] / sync['tps']:.2f}x sync"
                + (f", {r['tps'] / thread['tps']:.2f}x the thread plane's "
                   f"{thread['tps']:.1f}" if thread else "")
                + f"), {r['iter_ms']:.2f} ms an update of {r['per_iter']} "
                f"timesteps; learner update span {r['update_ms']:.2f} ms"
                + (f" (thread plane {thread['update_ms']:.2f})" if thread
                   else "")
                + f", learner idle {100 * r['learner_idle']:.1f}%, actor "
                f"(drainer) idle {100 * r['actor_idle']:.1f}%; staleness "
                f"mean {r['stale_mean']:.3f} max {r['stale_max']:.0f}; "
                f"workers' collect {r['collect_ms']:.2f} ms x{r['n_col']}, "
                f"param copy-in {r['copy_ms']:.3f} ms; the D2H publish into "
                f"shm {r['publish_ms']:.3f} ms an update; profiler window of "
                f"{window} (the parent's device work): busy "
                f"{r['busy_ms']:.3f} ms an update ({100 * r['busy']:.1f}%), "
                f"HtoD DMA {r['h2d_ms'] / window:.3f} ms x"
                f"{r['h2d_n'] / window:.0f} an update; one payload's copy "
                f"to the card alone, host-timed: {r['pageable_ms']:.3f} ms "
                f"from the pageable shm set, {r['pinned_ms']:.3f} ms from "
                f"page-locked memory ({card})")

    # (h) 32 PyBoundEnvs (spin 2000, GIL-held bytecode) on 1-8 workers
    vcfg = configs.get_config("paac_vector").replace(obs_shape=(16,),
                                                     num_actions=3)
    base = None
    for n_w in sweep:
        # the trainer's recipe; a shard's pool gets 8 / n_w threads
        spec = envs.py_bound_spec(n_envs, obs_dim=16, spin=env_spin,
                                  n_workers=min(8, n_envs), device=dev)
        free0, reserved0 = (torch.cuda.mem_get_info()[0],
                            torch.cuda.memory_reserved())
        rl = piped(spec, c=vcfg, lr=3e-3, queue_depth=4, num_actors=n_w)
        try:
            r = timed(rl, n_w, f"PyBoundEnv on {n_w} workers", sweep_iters,
                      free0, reserved0)
        finally:
            rl.close()
        for k, v in r["counts"].items():
            path[k] += v
        base = base or r
        env_tps = r["per_iter"] * n_w / (r["collect_ms"] / 1e3)
        say("host", f"(h) {n_envs} PyBoundEnvs, spin {env_spin}, on {n_w} "
            f"process worker(s) of {n_envs // n_w} envs: {sweep_iters} "
            f"updates, {r['tps']:.1f} timesteps/s "
            f"({r['tps'] / base['tps']:.2f}x one worker), the workers' "
            f"collect {r['collect_ms']:.2f} ms a rollout of "
            f"{r['per_iter']} timesteps (the workers together step "
            f"{env_tps:.0f} timesteps/s while collecting, "
            f"{env_tps / (base['per_iter'] / (base['collect_ms'] / 1e3)):.2f}"
            f"x one), learner update span {r['update_ms']:.2f} ms, learner "
            f"idle {100 * r['learner_idle']:.1f}% ({card})")

    # (i) lockstep process == lockstep thread host plane, bitwise
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        runs = []
        for backend in ("thread", "process"):
            spec = frame_spec(envs, np, n_envs, 0.0, n_workers, dev)
            rl = piped(spec, queue_depth=1, lockstep=True, rho_bar=inf,
                       c_bar=inf, actor_backend=backend)
            try:
                ops.reset_launches()
                res = rl.run(lock_iters)
                check(dict(ops.launches)["nstep_returns"] == lock_iters,
                      f"lockstep {backend}: launches {dict(ops.launches)}")
                segs = (rl._process_plane.segment_names()
                        if backend == "process" else [])
            finally:
                rl.close()
            runs.append((res, rl))
        check(not set(segs) & shm_now(), "lockstep: segments left")
        check_bitwise(torch, tree, *runs[1], *runs[0],
                      "lockstep process plane vs thread host plane")
        check(torch.equal(runs[0][1]._actor_keys[0][0].get_state(),
                          runs[1][1]._actor_keys[0][0].get_state()),
              "lockstep: the worker's acting generator came back different")
        del runs, rl
    finally:
        torch.backends.cudnn.deterministic = False
    say("host", f"(i) bitwise, cuDNN deterministic: {lock_iters} lockstep "
        "updates at rho_bar = c_bar = inf on one spawned worker equal the "
        "thread host plane's (metrics, every parameter, the acting "
        "generator's state brought back); every (actor_id, seq) was "
        "learned once in (g) and (h); after each close() no worker lived "
        "and no segment of the plane was left in /dev/shm")

    # (j) the trainer's process leg
    argv = ["--arch", "paac_vector", "--pipeline", "--actor-backend",
            "process", "--host-env", "--n-envs", str(n_envs), "--t-max",
            str(t_max), "--iterations", str(cli_iters), "--env-spin",
            str(env_spin), "--device", str(dev)]
    ops.reset_launches()
    t0 = time.perf_counter()
    res = train.main(argv)
    wall = time.perf_counter() - t0
    cli = dict(ops.launches)
    want = {k: cli_iters if k == "vtrace_returns" else 0 for k in cli}
    check(cli == want, f"train --actor-backend process: launches {cli}")
    check(len(res) == 1 and res[0].steps == cli_iters * n_envs * t_max
          and all(math.isfinite(v) for v in res[0].mean_metrics.values()),
          f"train --actor-backend process: {res}")
    say("host", f"(j) python -m repro_torch.launch.train {' '.join(argv)}: "
        f"{res[0].steps} steps, K1 {cli['nstep_returns']} K2 "
        f"{cli['vtrace_returns']}, {res[0].timesteps_per_sec:.1f} "
        f"timesteps/s (first run included; {wall:.1f} s with the spawn), "
        f"reward/iter {res[0].mean_metrics['reward_sum']:+.3f} ({card}); "
        f"the process legs took {time.perf_counter() - t_phase:.1f} s")
    return ({k: v for k, v in path.items() if v},
            {k: v for k, v in cli.items() if v})


def phase_replay(torch, configs, core, envs, A, optim, pipeline, ops, tree,
                 train, card, dev="cuda", n_envs=32, warmup=10, iters=100,
                 lock_iters=10, capacity=64, cli_iters=50):
    """The replay plane in the paper's setting (paac_nature,
    FrameStack(AtariLike(n_envs)), fp32, RMSProp lr 0.0007 n_e, t_max 5):
    depth-1 lockstep pipelined DQN ≡ ``SyncReplayDQN`` over two runs and
    PAAC at staleness 0 ≡ on-policy, bitwise; pipelined DQN, prioritized
    DQN and V-trace PAAC timed on a ring of ``capacity`` rollouts; the
    trainer's ``--replay`` legs. Returns the launch counts of the timed
    runs and of the trainer's legs."""
    t_phase = time.perf_counter()
    leaves = tree.tree_leaves
    inf = float("inf")
    t_max = 5
    lr = 0.0007 * n_envs

    def env():
        return envs.FrameStack(envs.AtariLike(n_envs, device=dev), 4)

    cfg = configs.get_config("paac_nature").replace(
        obs_shape=env().obs_shape, num_actions=env().num_actions)

    def dqn():
        return A.DQNAgent(cfg, A.DQNConfig(t_max=t_max))

    def paac():
        return A.PAACAgent(cfg, A.PAACConfig(gamma=0.99, entropy_beta=0.01,
                                             t_max=t_max))

    kw = dict(optimizer="rmsprop", lr_schedule=optim.constant(lr), seed=SEED,
              device=dev)

    def piped(agent, **cfg_kw):
        return pipeline.PipelinedRL(env(), agent, **kw,
                                    pipeline=configs.PipelineConfig(
                                        replay_plane=True, **cfg_kw))

    # (a) bitwise pins, cuDNN deterministic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        sync = pipeline.SyncReplayDQN(env(), dqn(), replay_capacity=8, **kw)
        pipe = piped(dqn(), queue_depth=1, lockstep=True, replay_capacity=8)
        ops.reset_launches()
        for n in (lock_iters, lock_iters // 2):
            check_bitwise(torch, tree, sync.run(n), sync, pipe.run(n), pipe,
                          f"lockstep replay DQN vs SyncReplayDQN ({n})",
                          DQN_METRICS)
        check(not any(ops.launches.values()),
              f"replay DQN launched {dict(ops.launches)}")
        on = pipeline.PipelinedRL(env(), paac(), **kw,
                                  pipeline=configs.PipelineConfig(
                                      queue_depth=1, lockstep=True))
        rep = piped(paac(), queue_depth=1, lockstep=True, replay_capacity=1)
        ops.reset_launches()
        check_bitwise(torch, tree, on.run(lock_iters), on,
                      rep.run(lock_iters), rep,
                      "replay PAAC at staleness 0, clips 1, vs the FIFO "
                      "device plane")
        k2 = dict(ops.launches)["vtrace_returns"]
        check(k2 == 2 * lock_iters, f"staleness-0 PAAC: K2 {k2}")
        ref = core.ParallelRL(env(), paac(), **kw)
        rep = piped(paac(), queue_depth=1, lockstep=True, replay_capacity=1,
                    rho_bar=inf, c_bar=inf)
        check_bitwise(torch, tree, ref.run(lock_iters), ref,
                      rep.run(lock_iters), rep,
                      "replay PAAC at staleness 0, clips inf, vs ParallelRL")
        del sync, pipe, on, rep, ref
    finally:
        torch.backends.cudnn.deterministic = False
    say("replay", f"(a) bitwise, cuDNN deterministic: depth-1 lockstep "
        f"pipelined DQN equals SyncReplayDQN over two runs ({lock_iters} + "
        f"{lock_iters // 2}, no kernel launched); replay PAAC at capacity 1 "
        f"(staleness 0) equals the FIFO device plane's lockstep run at "
        f"clips 1 (K2 {k2} over both) and ParallelRL at clips inf")

    # (b) timed legs on a ring of `capacity` rollouts
    path = {k: 0 for k in ops.launches}
    roll_bytes = None
    legs = (("DQN", dqn, {}, 0),
            ("DQN prioritized, batch 2", dqn,
             dict(prioritized=True, replay_batch=2), 0),
            ("PAAC V-trace, clips 1", paac, {}, iters))
    for label, make, extra, k2_want in legs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        rl = piped(make(), replay_capacity=capacity, **extra)
        rl.run(warmup)
        before = [t.clone() for t in leaves(rl.params)]
        ops.reset_launches()
        res = rl.run(iters)
        counts = dict(ops.launches)
        want = {k: k2_want if k == "vtrace_returns" else 0 for k in counts}
        check(counts == want, f"replay {label}: launches {counts}, "
              f"expected {want}")
        check(all(math.isfinite(v) for v in res.mean_metrics.values()),
              f"replay {label}: non-finite metrics {res.mean_metrics}")
        check(max((a - b).abs().max().item() for a, b in
                  zip(before, leaves(rl.params))) > 0,
              f"replay {label}: the parameters did not change")
        check(rl.learned_ids == [(-2, q) for q in range(iters)],
              f"replay {label}: learned {rl.learned_ids[:4]}...")
        for k, v in counts.items():
            path[k] += v
        m = res.mean_metrics
        wall_s = iters * n_envs * t_max / res.timesteps_per_sec
        update_ms, _ = span_stat(rl.telemetry, "learner", "learner.update")
        sample_ms, _ = span_stat(rl.telemetry, "replay", "replay.sample")
        peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
        if roll_bytes is None:  # obs and bootstrap, then the (T, E) rest
            roll_bytes = ((t_max + 1) * n_envs * math.prod(cfg.obs_shape) * 4
                          + t_max * n_envs * (8 + 4 + 1 + 4 + 4))
        say("replay", f"(b) pipelined {label} on a ring of {capacity} "
            f"rollouts ({roll_bytes / 1e6:.1f} MB each, "
            f"{capacity * roll_bytes / 1e9:.2f} GB resident when full), one "
            f"actor: {iters} updates after {warmup} warm-up, K1 "
            f"{counts['nstep_returns']} K2 {counts['vtrace_returns']}; "
            f"{res.timesteps_per_sec:.1f} timesteps/s, staleness mean "
            f"{m['staleness']:.2f} max {max(rl.staleness):.0f}, learner "
            f"idle {100 * res.learner_idle_s / wall_s:.1f}%, "
            f"update span {update_ms:.2f} ms, sample+concat {sample_ms:.3f} "
            f"ms, mean loss {m['loss']:.4f}; peak device memory above the "
            f"start {peak:.2f} GiB ({card})")
        del rl, before
        torch.cuda.empty_cache()

    # (c) the trainer's replay legs on TokenEnv
    base = ["--arch", "paac_vector", "--n-envs", str(n_envs), "--t-max",
            str(t_max), "--iterations", str(cli_iters), "--device", str(dev),
            "--pipeline", "--replay"]
    cli = {k: 0 for k in ops.launches}
    for extra, kernel in (([], "vtrace_returns"),
                          (["--algo", "dqn"], None)):
        ops.reset_launches()
        res = train.main(base + extra)
        counts = dict(ops.launches)
        want = {k: cli_iters if k == kernel else 0 for k in counts}
        check(counts == want, f"train {' '.join(base + extra)}: launches "
              f"{counts}, expected {want}")
        check(len(res) == 1 and res[0].steps == cli_iters * n_envs * t_max
              and all(math.isfinite(v) for v in res[0].mean_metrics.values()),
              f"train --replay {extra}: {res}")
        for k, v in counts.items():
            cli[k] += v
        say("replay", f"(c) python -m repro_torch.launch.train "
            f"{' '.join(base + extra)}: {res[0].steps} steps, K1 "
            f"{counts['nstep_returns']} K2 {counts['vtrace_returns']}, "
            f"{res[0].timesteps_per_sec:.1f} timesteps/s (first run "
            f"included), reward/iter {res[0].mean_metrics['reward_sum']:+.3f}"
            f" ({card}); the phase took "
            f"{time.perf_counter() - t_phase:.1f} s")
    return ({k: v for k, v in path.items() if v},
            {k: v for k, v in cli.items() if v})


# Each kernel's CUDA kernels as a profile names them. K4 and K5 share the
# combine (split_combine_kernel); no serving cell runs both. decode_kernel,
# decode_combine_kernel, mla_decode_kernel and ssd_scan_kernel (bf16) are
# the earlier designs' kernels, so a profile of those designs reads the
# same way.
PROFILE_NAMES = {
    "flash_attention": ("flash_fwd_kernel", "flash_fwd_bf16_kernel"),
    "decode_attention": ("decode_split_kernel", "split_combine_kernel",
                         "decode_combine_kernel", "decode_kernel"),
    "mla_decode_attention": ("mla_split_bf16_kernel", "mla_split_kernel",
                             "split_combine_kernel", "mla_decode_kernel"),
    "ssd_scan": ("ssd_chunk_kernel", "ssd_state_kernel", "ssd_out_kernel",
                 "ssd_scan_kernel"),
}


def kernel_time(by_name, kernel: str):
    """(ms, launches) of ``kernel``'s CUDA kernels in a ``device_window``
    table (demangled names: ``ns::name<...>(...)`` or ``ns::name(...)``)."""
    import re

    pat = re.compile(r"(?<![\w])(" + "|".join(PROFILE_NAMES[kernel])
                     + r")[<(]")
    hits = [row for name, row in by_name.items() if pat.search(name)]
    return sum(r[0] for r in hits), sum(r[1] for r in hits)


KERNELS = {
    "nstep_returns": ("src/repro_torch/csrc/nstep_returns.cu",
                      "src/repro/kernels/nstep_returns.py:54"),
    "vtrace_returns": ("src/repro_torch/csrc/vtrace.cu",
                       "src/repro/kernels/vtrace.py:92"),
    # the bf16 source: the serving paths run K3 in bf16 (the fp32 path,
    # csrc/flash_attention.cu, serves the card-vs-CPU parity checks)
    "flash_attention": ("src/repro_torch/csrc/flash_attention_bf16.cu",
                        "src/repro/kernels/flash_attention.py:113"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:103"),
    # K5 and K6 too: the bf16 sources, which the serving paths run
    "mla_decode_attention": ("src/repro_torch/csrc/mla_decode_bf16.cu",
                             "src/repro/kernels/mla_decode.py:113"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan_bf16.cu",
                 "src/repro/kernels/ssd_scan.py:86"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on one "
                                 "CUDA card")
    ap.add_argument("--trace-dir", default="",
                    help="also write the pipeline runs' Chrome traces here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import (configs, core, envs, models, optim, pipeline,
                             serving)
    from repro_torch.core import agents
    from repro_torch.core.agents import paac, replay
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as mk
    from repro_torch.kernels import nstep_returns as nr
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels import vtrace as vt
    from repro_torch.launch import paper_atari, serve, train
    from repro_torch.utils import tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    laps = []  # (phase, seconds since the previous lap)

    def lap(name):
        done = sum(t for _, t in laps)
        laps.append((name, time.perf_counter() - t0 - done))

    card = phase_card(torch, _build)
    lap("card")
    rows = {"nstep_returns": phase_returns(torch, ref, nr),
            "vtrace_returns": phase_vtrace(torch, ref, vt)}
    lap("returns, vtrace")
    rows.update(phase_kernels(torch, np, F, ref, fa, da))
    phase_latent_kernels(torch, np, F, ref, fa, mk, sk, rows)
    lap("kernels")
    phase_rl_model(torch, configs, models, envs, paac, optim, tree)
    # launches of each kernel on each main path, every path driven with the
    # counts set to 0 just before it and read just after
    by_path = {}
    by_path["training"], trained = phase_training(torch, paper_atari, ops,
                                                  tree, card)
    lap("rl_model, training")
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    by_path["pipeline"] = {"vtrace_returns": phase_pipeline(
        torch, paper_atari, configs, ops, tree, card,
        trace_dir=args.trace_dir or None)}
    lap("pipeline")
    by_path["agents"], by_path["train cli"] = phase_agents(
        torch, configs, models, envs, agents, replay, core, optim, tree, ops,
        train, card, trained)
    del trained
    lap("agents")
    (by_path["host sync"], by_path["host pipeline"],
     by_path["host train cli"], host_rows, delay) = phase_host(
        torch, np, configs, core, envs, agents, optim, pipeline, paper_atari,
        ops, tree, train, card)
    lap("host")
    by_path["host process"], by_path["host process train cli"] = \
        phase_host_process(torch, np, configs, envs, agents, optim, pipeline,
                           ops, tree, train, card, host_rows, delay)
    lap("host process")
    torch.cuda.empty_cache()
    by_path["replay"], by_path["replay train cli"] = phase_replay(
        torch, configs, core, envs, agents, optim, pipeline, ops, tree, train,
        card)
    lap("replay")
    torch.cuda.empty_cache()
    phase_model(torch, np, configs, models, ops, tree)
    lap("model")
    for cell in SERVING_CELLS:
        by_path[f"{cell['arch']} serving"] = phase_serving(
            torch, np, configs, models, ops, serve, serving, tree, card, cell)
    lap("serving")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name]
        paths = {path: c[name] for path, c in by_path.items() if c.get(name)}
        check(paths, f"{name} was launched on no main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **{k: row[k] for k in ("shape", "host_us", "launch_floor_ms",
                                   "other") if k in row}})
    say("done", "seconds a phase: " + ", ".join(f"{n} {t:.1f}"
                                                  for n, t in laps))
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

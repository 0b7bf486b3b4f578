#!/usr/bin/env python3
"""Time the port's n-step returns (K1) and V-trace (K2) kernels for one copy
of ``repro_torch``, on one CUDA card.

    python3 scripts/returns_profile.py [--src DIR] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured (by
default this checkout's); the measuring code is ``chip_smoke.py``'s, from
this checkout, so two versions of the kernels are measured by the same code,
as ``scripts/latent_profile.py`` does for K5 and K6. Compare two versions on
the same card, one after the other, in turns (A, B, B, A). In fp32, at
(T, E) = (5, 32) and (5, 256) (the training path at n_e = 32 and 256),
(5, 8) (K2 only: the four-actor pipeline), (64, 4096) and (4096, 256) (the
TPU kernel's design point, ``src/repro/kernels/nstep_returns.py:9``), each
kernel gets:

- ``ms``: CUDA-event time of the wrapper's launch (``chip_smoke.time_ms``:
  median of 30, L2 flushed, the card spun before each start event);
- ``device_ms``: the kernel's device time a call from a torch.profiler
  window of 20 calls, each after an L2 flush;
- ``floor_ms``: the launch floor, an empty kernel of the same library at
  the same grid, block and shared memory, launched through ctypes the same
  way and timed the same way (null where the library has none);
- ``host_us``: host microseconds a call of the wrapper, 1,000 calls on a
  busy card with no synchronize between them (``chip_smoke.host_us``);
- ``max_abs_err`` against the plain version on the same inputs (0 where
  the kernel is bitwise its plain version).

Prints one JSON object as its last line and appends it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K1_SHAPES = ((5, 32), (5, 256), (64, 4096), (4096, 256))
K2_SHAPES = ((5, 32), (5, 8), (5, 256), (64, 4096), (4096, 256))


def device_ms(torch, cs, fn, flush, kernel: str, n: int = 20) -> float:
    """Device time a call of the CUDA kernels whose name starts with
    ``kernel`` (``nstep`` or ``vtrace``: the chunked and the short kernel,
    or the earlier design's one), from a torch.profiler window of ``n``
    calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    _, by_name = cs.device_window(prof, n)
    return sum(ms for name, (ms, _) in by_name.items()
               if f"::{kernel}_" in name or name.startswith(f"{kernel}_"))


def max_err(torch, got, want) -> float:
    """Largest |got - want| where both are numbers; inf if inf or NaN stand
    in different places."""
    err = 0.0
    for g, w in zip(got, want):
        fin = torch.isfinite(w)
        if not torch.equal(fin, torch.isfinite(g)) or not torch.equal(
                g[~fin].nan_to_num(0.0, 1.0, -1.0),
                w[~fin].nan_to_num(0.0, 1.0, -1.0)):
            return float("inf")
        if fin.any():
            err = max(err, (g[fin] - w[fin]).abs().max().item())
    return err


def measure(torch, cs, mod, lib: str, kernel: str, shapes, make, call, plain,
            flush):
    rows = {}
    fn = getattr(mod._build.library(lib), f"{lib}_floor", None)
    for T, E in shapes:
        args = make(T, E)
        got, want = call(*args), plain(*args)
        if isinstance(got, torch.Tensor):  # K1: one output
            got, want = (got,), (want,)
        err = max_err(torch, got, want)
        row = {"ms": cs.time_ms(torch, lambda: call(*args), flush),
               "device_ms": device_ms(torch, cs, lambda: call(*args), flush,
                                      kernel),
               "floor_ms": None, "host_us": cs.host_us(torch,
                                                      lambda: call(*args)),
               "max_abs_err": err}
        if fn is not None:
            row["floor_ms"] = cs.time_ms(torch, cs.floor_launch(
                torch, mod._build, lib, mod.launch_shape, T, E), flush)
            row["shape"] = list(mod.launch_shape(T, E))
        rows[f"T={T} E={E}"] = row
        print(f"{kernel} T={T} E={E}: {row}", flush=True)
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
        print("returns_profile: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import nstep_returns as nr
    from repro_torch.kernels import ref
    from repro_torch.kernels import vtrace as vt

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"measuring {Path(nr.__file__).resolve()} on {card}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)

    def trajectory(T, E):
        r = torch.randn(T, E, generator=g, device=dev)
        d = torch.rand(T, E, generator=g, device=dev) < 0.1
        v = torch.randn(T, E, generator=g, device=dev)
        rho = torch.exp(0.5 * torch.randn(T, E, generator=g, device=dev))
        b = torch.randn(E, generator=g, device=dev)
        return r, d, v, b, rho

    def k1_args(T, E):
        r, d, _, b, _ = trajectory(T, E)
        return r, d, b, 0.99

    def k2_args(T, E):
        return trajectory(T, E) + (0.99, 1.0, 1.0)

    res = {"label": args.label, "card": card,
           "K1": measure(torch, cs, nr, "nstep_returns", "nstep",
                         K1_SHAPES, k1_args, nr.nstep_returns_cuda,
                         ref.nstep_returns_ref, flush),
           "K2": measure(torch, cs, vt, "vtrace", "vtrace",
                         K2_SHAPES, k2_args, vt.vtrace_returns_cuda,
                         ref.vtrace_returns_ref, flush)}
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

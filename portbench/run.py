"""One run of one benchmark cell of the PyTorch/CUDA port on its GPU.

    python3 portbench/run.py --workload paac_nature.sync.ne256 \\
        --seed 1234567 --seconds 20 --trace 0

Loads and warms up the cell with one call of the window's kind (set-up),
measures for ``--seconds``, checks that call's first steps against the
plain reference, and prints one JSON line
last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer ones, from one
profiled call after the window), ``device`` and, traced, ``breakdown``,
then ``checks``: each number compared beside its limit, which also end
standard error. Without the program (``src/repro_torch`` in the
checkout), without a CUDA device, with fewer than the cell's cards, or
with the JAX stack or the JAX package loaded, it prints no result and
exits non-zero. Build and kernel caches stay under ``build/`` in the
checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "extensions",
          "CUDA_CACHE_PATH": "nv", "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: no program under test: {ROOT / 'src'} holds no "
              f"repro_torch", file=sys.stderr)
        return 2
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import guard, harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), "cuda", T0)
    found = guard.forbidden(sys.modules)
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    errs = harness.schema_errors(result)
    if errs:
        print(f"portbench: malformed result: {errs}", file=sys.stderr)
        return 4
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

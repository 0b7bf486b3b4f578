#!/usr/bin/env python3
"""How deep a full-width token policy trains on one card.

For each (arch, layers) given, a fresh process builds the config at every
published width cut to ``layers`` layers and runs ``--steps`` PAAC
trajectory train steps (RMSProp, bf16, the config's remat) at B x T
through ``launch/train.py``'s synthetic code, then prints the peak device
memory (``torch.cuda.max_memory_allocated``), the mean step wall time and
the parameter count, or that the card ran out of memory. One process a
depth, so an earlier run's cached blocks do not count against a later
one. This is how ``chip_smoke.py``'s ``TRAIN_CELLS`` depths were chosen.

    python3 scripts/train_depth_probe.py qwen2-7b:13 qwen2-7b:14 \\
        minicpm3-4b:56 minicpm3-4b:58 --out depth.jsonl
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_config
from repro_torch.launch import train
arch, layers, B, T, steps = sys.argv[2], int(sys.argv[3]), *map(int, sys.argv[4:7])
cfg = get_config(arch).replace(num_layers=layers)
row = {"arch": arch, "layers": layers, "of": get_config(arch).num_layers,
       "B": B, "T": T, "steps": steps}
try:
    out = train.synthetic_steps(cfg, B, T, steps, 0, "cuda")
    row.update(ok=True, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               step_ms=1e3 * out["seconds"] / steps,
               n_params=out["n_params"], losses=out["losses"])
except torch.cuda.OutOfMemoryError:
    row.update(ok=False, peak_gb_at_oom=torch.cuda.max_memory_allocated() / 1e9)
print(json.dumps(row), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="+", help="arch:layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="", help="append the JSON lines here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("train_depth_probe: no CUDA device; nothing run",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for cell in args.cells:
        arch, layers = cell.split(":")
        r = subprocess.run(
            [sys.executable, "-c", CHILD, str(ROOT / "src"), arch, layers,
             str(args.batch), str(args.seq), str(args.steps)],
            capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-2000:], file=sys.stderr)
            return 1
        row = json.loads(r.stdout.strip().splitlines()[-1])
        row["card"] = card
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

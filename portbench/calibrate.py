"""The readings that a cell's limits are set from, in one process on the
card (the benchmark's own runs do not run this).

    python3 portbench/calibrate.py --workload paac_nature.sync.ne256 \\
        --seeds 12 --controls 3 --out chiprun_out/calib.jsonl

For each seed (drawn from ``--base``): the program's first steps checked
against the reference ("sound"); on the first ``--controls`` seeds also
the control (the reference in the program's place, in float32 with TF32
on, the precision below the configuration's) and the faults planted in
the reference in the program's place (``half``: the loss over half of the
batch; ``action``: one sampled action altered; ``frozen``: the state
returned unchanged; in a pipelined cell also ``stale``: every rollout
acted with the first parameters, and ``rho_one``: V-trace's importance
weights taken as 1). The stand-ins act each rollout with the behaviour
versions the program's run of the same seed showed, and the check follows
their weights as it follows the program's. One JSON line a reading, with
the numbers that are not compared beside those that are.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--base", type=int, default=3_000_000_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness, spec

    cell = spec.cell(args.workload)
    drv = harness.driver(cell)
    dev = torch.device("cuda")
    drv.set_precision(cell)
    out = open(args.out, "a") if args.out else None
    seeds = [args.base + 7919 * i for i in range(args.seeds)]

    def emit(kind, seed, nums, t):
        row = {"cell": cell.name, "kind": kind, "seed": seed,
               "seconds": time.perf_counter() - t, **nums}
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")

    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        observed = drv.release(drv.setup(cell, seed, dev))
        emit("sound", seed, drv.check(cell, seed, dev, observed, extra=True), t)
        if i >= args.controls:
            continue
        like = {"versions": observed.versions,
                "staleness_max": observed.staleness_max}
        t = time.perf_counter()
        emit("control_tf32", seed,
             drv.stand_in(cell, seed, dev, tf32=True, extra=True, **like), t)
        faults = ["half", "action", "frozen"]
        if cell.traffic["backend"] == "pipelined":
            faults += ["stale", "rho_one"]
        for fault in faults:
            t = time.perf_counter()
            emit(f"fault_{fault}", seed,
                 drv.stand_in(cell, seed, dev, tf32=False, fault=fault,
                              extra=True, **like), t)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

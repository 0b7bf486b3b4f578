"""Diagnosis of one dry-run pair of the port: run it on the fake 16 x 16
mesh and rank its top byte and collective contributors, per device, from
the trace of its local ops (``launch/trace_analysis.py``), summed over
every call of an op at one result shape.

    PYTHONPATH=src python scripts/diag_pair_torch.py qwen2-7b prefill_32k
    PYTHONPATH=src python scripts/diag_pair_torch.py minicpm3-4b decode_32k --absorb
    PYTHONPATH=src python scripts/diag_pair_torch.py glm4-9b decode_32k --tp
"""
import json
import logging
import os
import sys

from repro_torch.launch.dryrun import lower_pair


def diagnose(trace_path: str, top: int = 20) -> None:
    with open(trace_path) as f:
        rows = json.load(f)  # [kind, op, result shape, bytes], largest first
    for kind, title in (("bytes", "top HBM-byte contributors"),
                        ("wire", "top collective wire-byte contributors")):
        print(f"==== {title} ====")
        for _, op, shape, v in [r for r in rows if r[0] == kind][:top]:
            print(f"{v:12.3e}  {op:40s} {str(tuple(shape)):40s}")


if __name__ == "__main__":
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    arch, shape = sys.argv[1], sys.argv[2]
    kw = {}
    for a in sys.argv[3:]:
        if a == "--absorb":
            kw["mla_absorb"] = True
        if a == "--tp":
            kw["sharding_mode"] = "tp"
    os.makedirs("build/dryrun", exist_ok=True)
    trace = os.path.join("build/dryrun", f"{arch}_{shape}.trace.json")
    rep = lower_pair(arch, shape, save_trace=trace, measure_peak=False, **kw)
    t = rep["roofline"]
    print(f"terms: compute={t['compute_s']:.3f}s memory={t['memory_s']:.3f}s "
          f"collective={t['collective_s']:.3f}s bottleneck={t['bottleneck']}")
    print(f"replicated ops: {json.dumps(rep['replicated_ops'])}")
    diagnose(trace)

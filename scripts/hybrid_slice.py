#!/usr/bin/env python3
"""Run the zamba2-7b slice of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/hybrid_slice.py

Builds every kernel and prints the card's name and power limit
(``phase_card``), then runs phase 3 (K3 and K4 over their sweeps, timed
at each serving path's shapes, zamba2-7b's among them) and K3, K5 and K6
at the latent shapes (K6 also at zamba2-7b's prefill: H=112 N=64), the
reduced zamba2-7b case of phase 6 (card against CPU, launch counts) and
the full-depth zamba2-7b serving cell of phase 7 with its F14 check. The
code measured and the checks are ``chip_smoke.py``'s; a failed check
raises. Prints the K3, K4 and K6 rows and the serving cell's launch counts
as JSON lines.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402


def main():
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch import analysis, configs, models, optim, serving
    from repro_torch.analysis import sanitize
    from repro_torch.core.agents import paac
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as mk
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.launch import serve
    from repro_torch.utils import tree

    if not torch.cuda.is_available():
        print("hybrid_slice: no CUDA device; nothing run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = cs.phase_card(torch, _build)
    rows = cs.phase_kernels(torch, np, F, ref, fa, da)
    cs.phase_latent_kernels(torch, np, F, ref, fa, mk, sk, rows)
    print(json.dumps({k: rows[k] for k in ("flash_attention",
                                           "decode_attention", "ssd_scan")}))
    cs.MODEL_CASES = tuple(c for c in cs.MODEL_CASES if c[0] == "zamba2-7b")
    cs.phase_model(torch, np, configs, models, ops, paac, optim, tree)
    cell = next(c for c in cs.SERVING_CELLS if c["arch"] == "zamba2-7b")
    counts = cs.phase_serving(torch, np, configs, models, ops, serve, serving,
                              tree, card, cell, analysis, sanitize)
    print(json.dumps(counts))
    print(f"hybrid slice done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

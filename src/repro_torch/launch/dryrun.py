"""The dry-run: every (arch × shape × mesh) pair's step on placeholder
devices (a port of ``repro.launch.dryrun``).

The reference lowers and compiles each pair's jitted step for 256 or 512
placeholder TPU devices. Its torch counterpart runs the step itself, as
DTensor ops, under ``FakeTensorMode`` on a ``"fake"`` process group of as
many ranks as the mesh has devices: shapes, placements and collectives
are real, and nothing is allocated or computed. It needs no hardware and
runs on the CPU, as the reference's does; it initialises no process group
at import.

For each pair: the parameters (``init_policy`` on fake tensors), the
RMSProp state, the batch (``data.specs``) and the cache are distributed
by the sharding rules (``distributed.sharding``); the train, prefill or
decode step runs inside ``axis_context`` (so the models' ``constrain``
calls redistribute); ``trace_analysis.LocalCostMode`` counts one device's
FLOPs, bytes and collective wire bytes, and ``CommDebugMode`` counts the
collectives DTensor issues. An op DTensor cannot shard runs replicated
(``launch/fallback.py``) and is listed under ``"replicated_ops"`` with the
bytes its gathers bring. A pair that fails prints ``FAIL`` and the
command exits non-zero.

The report keeps the reference's keys. ``lower_s`` is the set-up (the
fake init and the distribution), ``compile_s`` the step's run on fake
tensors; ``memory_analysis`` gives ``argument_bytes`` (one device's part
of every argument, from the specs), ``output_bytes`` (one device's part
of the step's outputs) and, where ``mem_tracker`` can measure one under
fake tensors, ``peak_bytes`` (else null, with the reason);
``raw_cost_analysis`` (XLA's own counts in the reference) is null.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all            # every pair
    python -m repro_torch.launch.dryrun --all --multi-pod
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
import traceback
import warnings

import torch

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.data.specs import input_specs
from repro_torch.distributed.constraints import axis_context
from repro_torch.distributed.sharding import (cache_specs, input_sharding,
                                              param_specs, shard_shape,
                                              spec_leaves, to_placements)
from repro_torch.launch.analysis import model_flops, roofline_terms
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step)
from repro_torch.models import init_policy, init_policy_cache
from repro_torch.utils.tree import tree_leaves, tree_map

SWA_WINDOW = 8192  # sliding-window variant used for long_500k on attn archs


def adjust_cfg(cfg, shape_name: str):
    """Per-shape config adjustments, as the reference makes them."""
    if shape_name == "long_500k":
        if not cfg.supports_long_context:
            return None  # skipped (the speech encoder-decoder)
        if cfg.family not in ("ssm",):
            cfg = cfg.replace(sliding_window=SWA_WINDOW)
    return cfg


def skip_reason(cfg, shape_name: str):
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("enc-dec speech model: no 500k autoregressive decode "
                "(DESIGN.md §4)")
    return None


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks (this process is
    rank 0) for the context, destroyed after it. An active group of at
    least that size is used as it is and left alone."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"active; the mesh needs {world_size}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _distribute(tree, specs, device_mesh):
    """``tree``'s leaves as DTensors placed by ``specs``."""
    from torch.distributed.tensor import distribute_tensor

    it = iter(spec_leaves(to_placements(specs, device_mesh)))
    return tree_map(lambda t: distribute_tensor(t, device_mesh, next(it)),
                    tree)


def device_bytes(tree, specs, mesh, itemsize=None) -> int:
    """One device's bytes of ``tree`` placed by ``specs`` (at ``itemsize``
    bytes an element when given, else each leaf's own)."""
    return sum(torch.Size(shard_shape(t.shape, s, mesh)).numel()
               * (itemsize or t.element_size())
               for t, s in zip(tree_leaves(tree), spec_leaves(specs)))


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for x in torch.utils._pytree.tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def _fake(fn):
    """``fn()`` on fake tensors, in a mode of its own."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return fn()


def _peak(run):
    """(result of ``run()``, peak bytes or None, reason when None): the peak
    of live bytes ``mem_tracker`` sees over the step."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
    except ImportError as e:  # pragma: no cover - torch without the tool
        return run(), None, f"mem_tracker unavailable: {e}"
    tracker = MemTracker()
    try:
        with tracker:
            out = run()
    except Exception as e:  # noqa: BLE001 - reported, then run plainly
        reason = f"mem_tracker failed under fake tensors: {type(e).__name__}"
        return None, None, reason
    peak = tracker.get_tracker_snapshot("peak")
    total = sum(v.get("Total", 0) for v in peak.values()) if peak else 0
    if not total:
        return out, None, "mem_tracker saw no live bytes under fake tensors"
    return out, int(total), None


def plan_bytes(cfg, *, batch: int, max_len: int) -> dict:
    """The bytes of each leaf of ``cfg``'s parameters and of its cache, from
    a fake init (one device's on the 1 x 1 host mesh, where the rules
    shard nothing): ``{"params", "cache"}`` in bytes and
    ``{"param_leaves", "cache_leaves"}``; ``batch`` and ``max_len`` size
    the cache as ``init_policy_cache`` does."""

    def trees():
        params = init_policy(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
        return params, init_policy_cache(cfg, batch, max_len, device="cpu")

    params, cache = _fake(trees)
    p_leaves = [t.numel() * t.element_size() for t in tree_leaves(params)]
    c_leaves = [t.numel() * t.element_size() for t in tree_leaves(cache)]
    return {"params": sum(p_leaves), "param_leaves": p_leaves,
            "cache": sum(c_leaves), "cache_leaves": c_leaves}


def lower_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
               sharding_mode: str = "fsdp_tp", mla_absorb: bool = False,
               save_trace: str = "", cfg=None, mesh=None,
               measure_peak: bool = True):
    """Run one pair's step on a fake mesh. Returns a report dict (or a skip
    record). ``cfg`` replaces ``get_config(arch)`` and ``mesh`` (a
    ``ProductionMesh``, built or not) the production mesh; the tests use
    both. ``save_trace`` writes the per-op contributors as JSON;
    ``measure_peak=False`` leaves out ``mem_tracker`` (the reference's
    ``donate`` has no counterpart: an eager step returns new trees)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.fallback import replicate_fallbacks
    from repro_torch.launch.trace_analysis import LocalCostMode

    cfg0 = cfg if cfg is not None else get_config(arch)
    reason = skip_reason(cfg0, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    cfg = adjust_cfg(cfg0, shape_name)
    if mla_absorb and cfg.attention == "mla":
        cfg = cfg.replace(mla_absorb=True)
    shp = INPUT_SHAPES[shape_name]
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    chips = mesh.size
    B, S = shp.global_batch, shp.seq_len
    t0 = time.time()

    with contextlib.ExitStack() as stack:
        stack.enter_context(fake_process_group(chips))
        stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("ignore")
        if mesh.device_mesh is None:
            mesh = mesh.build()
        dm = mesh.device_mesh
        fake = stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
        gen = torch.Generator().manual_seed(0)
        params = init_policy(cfg, generator=gen, device="cpu")
        p_specs = param_specs(params, mesh, sharding_mode)
        args = [_distribute(params, p_specs, dm)]
        arg_bytes = device_bytes(params, p_specs, mesh)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in input_specs(cfg, shape_name).items()}
        b_specs = input_sharding(batch, mesh)
        dbatch = _distribute(batch, b_specs, dm)
        arg_bytes += device_bytes(batch, b_specs, mesh)
        if shp.kind == "train":
            step_fn, opt = build_train_step(cfg, n_e=B)
            opt_state = opt.init(params)
            # zero1: params as "tp", optimizer state as "fsdp_tp" (ZeRO-1)
            opt_mode = "fsdp_tp" if sharding_mode == "zero1" else sharding_mode
            o_specs = param_specs(opt_state, mesh, opt_mode)
            args += [_distribute(opt_state, o_specs, dm), dbatch, 0]
            arg_bytes += device_bytes(opt_state, o_specs, mesh)
            tokens = B * (S - cfg.prefix_len)
        elif shp.kind == "prefill":
            step_fn = build_prefill_step(cfg)
            args.append(dbatch)
            tokens = B * (S - cfg.prefix_len)
        else:
            step_fn = build_serve_step(cfg)
            cache = init_policy_cache(cfg, B, S, device="cpu")
            c_specs = cache_specs(cache, mesh)
            args += [_distribute(cache, c_specs, dm), dbatch["token"], S - 1,
                     torch.Generator().manual_seed(0)]
            arg_bytes += device_bytes(cache, c_specs, mesh)
            tokens = B  # one new token per actor
        t_lower = time.time() - t0

        local = LocalCostMode()
        comm = CommDebugMode()

        def run():
            with comm, local:
                return step_fn(*args)

        stack.enter_context(axis_context(mesh))
        stack.enter_context(implicit_replication())
        fallbacks = stack.enter_context(replicate_fallbacks())
        grad = shp.kind == "train"
        stack.enter_context(torch.set_grad_enabled(grad))
        if measure_peak:
            out, peak, peak_note = _peak(run)
            if out is None:  # the tracker failed: run without it
                local, comm = LocalCostMode(), CommDebugMode()
                out = run()
        else:
            out, peak, peak_note = run(), None, "not measured (measure_peak)"
        t_compile = time.time() - t0 - t_lower
        out_bytes = _local_bytes(out)
        del fake
    del out, args

    static = local.report()
    flops, byac = static["flops"], static["bytes"]
    coll = {k.replace("wire_", ""): v for k, v in static.items()
            if k.startswith("wire_")}
    coll["total_wire_bytes"] = static["collective_wire_bytes"]
    terms = roofline_terms(flops, byac, coll["total_wire_bytes"])
    mf6 = model_flops(cfg, params, tokens)  # 6·N_active·tokens
    # 6ND counts fwd+bwd (train); inference is fwd-only -> 2ND
    useful = mf6 if shp.kind == "train" else mf6 / 3.0
    comm_counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    if save_trace:
        top = sorted(local.by_op.items(), key=lambda kv: -kv[1])
        with open(save_trace, "w") as f:
            json.dump([[kind, op, list(shape), v]
                       for (kind, op, shape), v in top], f)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(map(str, mesh.dims)),
        "chips": chips,
        "sharding_mode": sharding_mode,
        "mla_absorb": bool(mla_absorb and cfg0.attention == "mla"),
        "kind": shp.kind,
        "tokens_per_step": tokens,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "flops_per_chip": flops,
        "bytes_per_chip": byac,
        "collectives": coll,
        "collective_counts": static.get("collective_counts", {}),
        "comm_debug_counts": comm_counts,
        "raw_cost_analysis": {
            "flops": None,
            "bytes_accessed": None,
            "note": "XLA's cost_analysis has no counterpart: the counts "
                    "above are the local ops' (trace_analysis.py)",
        },
        "memory_analysis": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "peak_bytes": peak,
            "peak_note": peak_note,
        },
        "replicated_ops": {k: dict(v) for k, v in fallbacks.items()},
        "roofline": terms,
        "model_flops_global": useful,
        "useful_flops_ratio": (useful / (flops * chips)) if flops else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED_ARCHS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(INPUT_SHAPES) + ["all"],
                    default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sharding-mode", default="fsdp_tp",
                    choices=("tp", "fsdp_tp"))
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    # DTensor's warnings (a CPU group's all-to-all, two sequential
    # all-reduces) would repeat for every op; the report counts them
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    archs = ASSIGNED_ARCHS if (args.arch == "all" or args.all) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.shape == "all" or args.all)
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t_all = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                if args.mla_absorb:
                    tag += "_absorb"
                t_pair = time.time()
                try:
                    rep = lower_pair(arch, shape, multi_pod=mp,
                                     sharding_mode=args.sharding_mode,
                                     mla_absorb=args.mla_absorb)
                except Exception:
                    failures += 1
                    rep = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "error": traceback.format_exc(limit=20)}
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rep, f, indent=2, default=str)
                if "error" in rep:
                    print(f"FAIL {tag}")
                    print(rep["error"].strip().splitlines()[-1])
                elif "skipped" in rep:
                    print(f"SKIP {tag}: {rep['skipped']}")
                else:
                    r = rep["roofline"]
                    rep_ops = ",".join(
                        f"{k}:{v['gathered_bytes']:.3e}"
                        for k, v in rep["replicated_ops"].items()) or "none"
                    print(
                        f"OK   {tag}: {time.time() - t_pair:.1f}s "
                        f"(setup {rep['lower_s']}s step {rep['compile_s']}s) "
                        f"flops/chip={rep['flops_per_chip']:.3e} "
                        f"bytes/chip={rep['bytes_per_chip']:.3e} "
                        f"wire={rep['collectives']['total_wire_bytes']:.3e} "
                        f"bottleneck={r['bottleneck']} replicated={rep_ops}",
                        flush=True)
    print(f"dryrun: {failures} failure(s) in {time.time() - t_all:.1f} s")
    if failures:
        raise SystemExit(f"{failures} pair(s) failed")


if __name__ == "__main__":
    main()

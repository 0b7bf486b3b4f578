"""Training launcher — the port of ``repro/launch/train.py``.

``--mode rl`` runs full PAAC RL (Algorithm 1) against the k-back echo
``TokenEnv`` — rollout with the current policy, synchronous update — on
the card, or on the CPU with ``--device cpu`` (without a CUDA device the
default raises). A token arch acts on the token context's last position
and learns through K3 and its backward in its attention layers (qwen2-7b,
glm4-9b, deepseek-coder-33b, minicpm3-4b, dbrx-132b, deepseek-v2-236b,
pixtral-12b, seamless-m4t-large-v2, zamba2-7b's shared block) and K6 and
its backward in its Mamba2 layers (mamba2-370m, the default, and
zamba2-7b); ``paac_vector`` acts on the raw token ids.
``--mode synthetic`` is the profiling path with no env loop: a random
trajectory batch (B = ``--n-envs``, T = ``--t-max``) through the token
arch's trajectory train step (``launch.steps.build_train_step``), timed
with the card synchronised. ``--algo dqn`` selects the value-based agent: the
synchronous DQN with its own replay buffer. ``--host-env`` swaps the
TokenEnv for the paper's host env plane: a ``HostEnvPool`` of GIL-holding
Python emulators (``PyBoundEnv``, ``--env-spin`` pure-Python work a step,
16-wide observations, 3 actions) stepped by up to 8 worker threads.
``--pipeline`` swaps the synchronous ``ParallelRL`` backend for the
asynchronous actor/learner pipeline (``repro_torch.pipeline.PipelinedRL``):
``--num-actors`` replicas (the env axis split between them) collect
rollouts while the learner consumes earlier ones, with ``--queue-depth``
bounding staleness and ``--rho-bar``/``--c-bar`` the V-trace clips (K2) on
the off-policy importance correction. ``--actor-backend process`` (which
implies ``--host-env``) runs each replica in a spawned worker subprocess
over shared memory, the backend that scales GIL-holding emulators.
``--rollout-plane`` picks the trajectory plane: the device ring (tensor
envs), or the host staging queue (``--host-env`` pools; on the TokenEnv
the GA3C-style baseline), or the mesh plane, which ``--mesh D`` > 1 also
selects: one actor lane a device of a D-lane rollout mesh (on the CPU,
with ``--device cpu``, D lanes that share it), each lane's shard of the
env axis learned through the sharded step (V-trace through K2 on each
lane's device, the gradients summed on lane 0). ``--replay`` swaps the FIFO ring for the sampled
``ReplayRing``: actors never block, and each update samples
``--replay-batch`` of the ``--replay-capacity`` resident rollouts
(uniformly, or TD-error-weighted with ``--prioritized``); ``--algo paac``
then runs the V-trace learner on stale sampled rollouts and ``--algo
dqn`` the replay-fed TD learner. ``--trace`` writes a Chrome trace of the
pipeline's spans, ``--metrics-jsonl`` a JSONL liveness heartbeat, and
``--stall-timeout`` arms the stall watchdog, which names the stage each
party is blocked in when progress stops. The pipeline's fault-tolerance
plane: ``--elastic`` supervises the replicas (respawn under
``--restart-budget``, then degrade to the survivors), ``--fault-kill
SLOT:AFTER[:MODE]`` and ``--fault-stall-learner ITER:SECONDS`` inject
planned faults, ``--checkpoint-dir``/``--checkpoint-every`` save the full
pipeline state every so many updates and ``--resume`` restores the newest
and runs only the remaining iterations; ``--checkpoint DIR`` saves the
final params (any backend). ``--sanitize locks,transfers`` arms the
runtime sanitizers (``repro_torch.analysis``) for a ``--pipeline`` run:
the lock-order monitor, whose cycle or hazard fails the launch, and the
host-sync guard over the learner's and the device collects' steady
state. The synchronous PAAC update computes its n-step returns through
K1.

The parser takes every flag of the reference, with its defaults, plus
``--device``. Every ``SystemExit`` of the reference's flag validation comes
in the reference's order with its text. ``--arch`` defaults to the
reference's ``mamba2-370m`` at full width.

Examples (``paac_vector`` for the agents and planes that need a vector
policy):
    PYTHONPATH=src python -m repro_torch.launch.train --iterations 20
    PYTHONPATH=src python -m repro_torch.launch.train --mode synthetic \\
        --arch zamba2-7b --reduced
    PYTHONPATH=src python -m repro_torch.launch.train --arch paac_vector \\
        --iterations 50 --pipeline --num-actors 4 --n-envs 16
    PYTHONPATH=src python -m repro_torch.launch.train --arch paac_vector \\
        --iterations 50 --algo dqn
    PYTHONPATH=src python -m repro_torch.launch.train --arch paac_vector \\
        --iterations 50 --host-env --n-envs 32 --pipeline \\
        --metrics-jsonl hb.jsonl
    PYTHONPATH=src python -m repro_torch.launch.train --arch paac_vector \\
        --iterations 50 --n-envs 32 --pipeline --actor-backend process \\
        --num-actors 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch paac_vector \\
        --iterations 50 --algo dqn --pipeline --replay --replay-capacity 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch paac_vector \\
        --iterations 50 --pipeline --elastic --fault-kill 0:3 \\
        --checkpoint-dir ck --checkpoint-every 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch paac_vector \\
        --iterations 50 --pipeline --checkpoint-dir ck --resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch paac_vector \\
        --iterations 100 --pipeline --sanitize locks,transfers
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch mamba2-370m --reduced --iterations 4 --n-envs 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paac_vector --pipeline --mesh 2 --iterations 8 --n-envs 8
"""
from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import torch

from repro_torch.analysis import (disable_sanitizers, enable_sanitizers,
                                  parse_modes)
from repro_torch.analysis.lockcheck import monitor
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import PipelineConfig, get_config
from repro_torch.core.agents import (DQNAgent, DQNConfig, PAACAgent,
                                     PAACConfig)
from repro_torch.core.framework import ParallelRL, RunResult
from repro_torch.device import resolve_device
from repro_torch.envs import TokenEnv, py_bound_spec
from repro_torch.launch.steps import build_train_step
from repro_torch.models import init_policy
from repro_torch.optim import constant
from repro_torch.pipeline import FaultPlan, PipelinedRL
from repro_torch.utils import get_logger
from repro_torch.utils.tree import tree_leaves

log = get_logger("train")

# the reference's assigned architectures (repro.configs.ASSIGNED_ARCHS)
ASSIGNED_ARCHS = [
    "minicpm3-4b",
    "glm4-9b",
    "deepseek-v2-236b",
    "seamless-m4t-large-v2",
    "deepseek-coder-33b",
    "dbrx-132b",
    "qwen2-7b",
    "zamba2-7b",
    "pixtral-12b",
    "mamba2-370m",
]


def _refuse_invalid(args) -> None:
    """The reference's ``SystemExit``s, in its order, with its text."""
    if args.actor_backend == "process" and not args.pipeline:
        raise SystemExit(
            "--actor-backend process is a pipeline backend: add --pipeline "
            "(the synchronous ParallelRL driver has no actor replicas)")
    if args.mesh > 1 and not args.pipeline:
        raise SystemExit(
            "--mesh is a pipeline (mesh rollout plane) knob: add --pipeline")
    if (args.trace or args.metrics_jsonl or args.stall_timeout) \
            and not args.pipeline:
        raise SystemExit(
            "--trace/--metrics-jsonl/--stall-timeout observe the pipeline "
            "backend's telemetry hub: add --pipeline")
    if args.sanitize and not args.pipeline:
        raise SystemExit(
            "--sanitize arms the pipeline backend's runtime sanitizers "
            "(repro.analysis): add --pipeline")
    if args.sanitize:
        try:
            parse_modes(args.sanitize)
        except ValueError as e:
            raise SystemExit(f"--sanitize: {e}")
    if args.replay and not args.pipeline:
        raise SystemExit(
            "--replay selects the pipeline's sampled ReplayRing plane: add "
            "--pipeline (the synchronous DQN has its own scan-based replay)")
    if args.prioritized and not args.replay:
        raise SystemExit(
            "--prioritized weights the ReplayRing's sampling: add --replay")
    if args.algo == "dqn" and args.pipeline and not args.replay:
        raise SystemExit(
            "--algo dqn under --pipeline needs the replay plane: add "
            "--replay (the FIFO planes feed the on-policy V-trace learner)")
    if args.replay and (args.host_env or args.actor_backend == "process"):
        raise SystemExit(
            "--replay requires a JAX-native env on the device plane: it "
            "cannot combine with --host-env/--actor-backend process")
    if (args.elastic or args.fault_kill or args.fault_stall_learner
            or args.checkpoint_every or args.resume) and not args.pipeline:
        raise SystemExit(
            "--elastic/--fault-*/--checkpoint-every/--resume drive the "
            "pipeline backend's fault-tolerance plane: add --pipeline")
    if (args.checkpoint_every or args.resume) and not args.checkpoint_dir:
        raise SystemExit(
            "--checkpoint-every/--resume need --checkpoint-dir (where the "
            "pipeline's full-state snapshots live)")
    # the reference's cfg.family != "cnn": of the trainer's archs only
    # paac_vector is of the vector/cnn family
    if (args.host_env or args.actor_backend == "process") \
            and args.arch != "paac_vector":
        raise SystemExit(
            f"--host-env/--actor-backend process need a vector/cnn "
            f"policy (e.g. --arch paac_vector), got {args.arch}")


def _fault_plan(args):
    """The ``FaultPlan`` of ``--fault-kill``/``--fault-stall-learner``
    (``None`` without either), with the reference's exits on a malformed
    entry."""
    if not (args.fault_kill or args.fault_stall_learner):
        return None
    kills = []
    for spec in args.fault_kill:
        parts = spec.split(":")
        if len(parts) not in (2, 3):
            raise SystemExit(
                f"--fault-kill {spec!r}: expected slot:after_rollouts[:mode]")
        kills.append((int(parts[0]), int(parts[1]),
                      parts[2] if len(parts) == 3 else "error"))
    stalls = []
    for spec in args.fault_stall_learner:
        it, _, sec = spec.partition(":")
        if not sec:
            raise SystemExit(
                f"--fault-stall-learner {spec!r}: expected iteration:seconds")
        stalls.append((int(it), float(sec)))
    return FaultPlan(kills=tuple(kills), stall_learner=tuple(stalls))


def run_rl(args) -> Tuple[object, List[RunResult]]:
    """Build and run the backend ``args`` select. Returns the backend and
    one ``RunResult`` an epoch. ``--sanitize`` arms its modes for this
    call only; with ``locks`` a lock-order cycle or hazard in the run
    exits non-zero after it."""
    _refuse_invalid(args)
    modes = parse_modes(args.sanitize)
    if not modes:
        return _run_rl(args)
    enable_sanitizers(modes)
    monitor().reset()  # the verdict covers this launch
    log.info("sanitizers armed: %s", ",".join(sorted(modes)))
    try:
        out = _run_rl(args)
    finally:
        disable_sanitizers(modes)
    if "locks" in modes:
        rep = monitor().report()
        if rep["cycles"] or rep["hazards"]:
            for cyc in rep["cycles"]:
                log.error("lockcheck: lock-order cycle %s", " -> ".join(cyc))
            for h in rep["hazards"]:
                log.error("lockcheck: %s waited on %s while holding %s",
                          h["thread"], h["waiting_on"],
                          ", ".join(h["holding"]))
            raise SystemExit(
                f"lockcheck: {len(rep['cycles'])} cycle(s), "
                f"{len(rep['hazards'])} hazard(s) — see log")
        log.info("lockcheck: %d lock-order edge(s), no cycles, no hazards",
                 len(rep["edges"]))
    return out


def _run_rl(args) -> Tuple[object, List[RunResult]]:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    host_env = args.host_env or args.actor_backend == "process"
    if host_env:
        # the GIL-holding external-emulator pool (repro_torch.envs.pyemu),
        # the regime the process backend exists for
        spec = py_bound_spec(args.n_envs, obs_dim=16, spin=args.env_spin,
                             n_workers=min(8, args.n_envs), device=str(dev))
        cfg = cfg.replace(obs_shape=spec.obs_shape, num_actions=3)
        env = spec if args.pipeline else spec.build()
    else:
        env = TokenEnv(args.n_envs, vocab=min(cfg.vocab_size, 64),
                       ctx=args.ctx, k=2, horizon=64, device=dev)
        cfg = cfg.replace(num_actions=env.vocab)
        if cfg.family == "cnn":  # the vector policy acts on the raw ids
            cfg = cfg.replace(obs_shape=env.obs_shape)
    if args.algo == "dqn":
        agent = DQNAgent(cfg, DQNConfig(t_max=args.t_max))
    else:
        agent = PAACAgent(cfg, PAACConfig(t_max=args.t_max,
                                          entropy_beta=0.01))
    if args.pipeline:
        rl = PipelinedRL(
            env, agent, lr_schedule=constant(args.lr), seed=args.seed,
            device=dev,
            pipeline=PipelineConfig(queue_depth=args.queue_depth,
                                    rho_bar=args.rho_bar, c_bar=args.c_bar,
                                    num_actors=args.num_actors,
                                    rollout_plane=args.rollout_plane,
                                    actor_backend=args.actor_backend,
                                    mesh_shape=args.mesh,
                                    replay_plane=args.replay,
                                    replay_capacity=args.replay_capacity,
                                    replay_batch=args.replay_batch,
                                    prioritized=args.prioritized,
                                    lease_timeout_s=args.lease_timeout,
                                    trace_path=args.trace,
                                    metrics_jsonl=args.metrics_jsonl,
                                    stall_timeout_s=args.stall_timeout,
                                    elastic=args.elastic,
                                    restart_budget=args.restart_budget,
                                    restart_backoff_s=args.restart_backoff,
                                    fault_plan=_fault_plan(args),
                                    checkpoint_dir=args.checkpoint_dir,
                                    checkpoint_every=args.checkpoint_every))
    else:
        try:
            rl = ParallelRL(env, agent, lr_schedule=constant(args.lr),
                            seed=args.seed, device=dev)
        except BaseException:
            if host_env:
                env.close()
            raise
    results = []
    try:
        resume_done = 0
        if args.pipeline and args.resume:
            resume_done = rl.restore()
            if resume_done:
                log.info("resume: checkpoint covers %d update(s) — running "
                         "the remainder", resume_done)
        for epoch in range(args.epochs):
            iters = args.iterations
            if epoch == 0 and resume_done:
                iters = max(args.iterations - resume_done, 0)
                if iters == 0:
                    log.info("resume: epoch 0 fully covered by checkpoint")
                    continue
            res = rl.run(iters, log_every=max(args.iterations // 4, 1))
            log.info(
                "epoch %d steps=%d mean_reward/iter=%.3f tps=%.0f%s",
                epoch, res.steps, res.mean_metrics.get("reward_sum", 0.0),
                res.timesteps_per_sec,
                (f" staleness={res.mean_metrics.get('staleness', 0.0):.1f}"
                 f" actor_idle={res.actor_idle_s:.2f}s"
                 f" learner_idle={res.learner_idle_s:.2f}s"
                 if args.pipeline else ""))
            results.append(res)
        if args.checkpoint:
            save_checkpoint(args.checkpoint, rl.total_steps, rl.params)
            log.info("checkpoint saved to %s", args.checkpoint)
    finally:
        if hasattr(rl, "close"):
            rl.close()  # the workers or the pools built from the spec
        elif host_env:
            env.close()
    return rl, results


def synthetic_batch(cfg, B: int, T: int, generator, device):
    """The synthetic trajectory batch: tokens (B, T+1) uniform over the
    vocabulary, rewards (B, T) uniform in [0, 1), no dones. A vision trunk
    also gets ``prefix`` and an encoder-decoder ``frames``, standard normal
    embeddings of ``prefix_len`` and ``encoder_seq_len`` rows (the
    reference's batch has neither, and its step needs them)."""
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (B, T + 1),
                                generator=generator, device=device),
        "rewards": torch.rand((B, T), generator=generator, device=device),
        "dones": torch.zeros((B, T), dtype=torch.bool, device=device),
    }
    if cfg.modality == "vision":
        batch["prefix"] = torch.randn((B, cfg.prefix_len, cfg.frontend_dim),
                                      generator=generator, device=device)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn(
            (B, cfg.encoder_seq_len, cfg.frontend_dim or cfg.d_model),
            generator=generator, device=device)
    return batch


def synthetic_steps(cfg, B: int, T: int, iterations: int, seed: int = 0,
                    device="cuda", on_step=None) -> dict:
    """``iterations`` PAAC trajectory train steps (RMSProp,
    ``paac_scaled_lr(B)``) of ``cfg`` on one synthetic batch from ``seed``.
    ``on_step(i, metrics)``, when given, is called after each step with
    the card synchronised. Returns {"seconds": the steps' wall time,
    "tokens_per_s", "losses": the loss of each step, "n_params"}."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_policy(cfg, generator=gen, device=dev)
    step_fn, opt = build_train_step(cfg, n_e=B)
    opt_state = opt.init(params)
    batch = synthetic_batch(cfg, B, T, gen, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    losses = []
    sync()
    t0 = time.perf_counter()
    for i in range(iterations):
        params, opt_state, metrics = step_fn(params, opt_state, batch, i)
        losses.append(metrics["loss"])
        if on_step is not None:
            sync()
            on_step(i, metrics)
    sync()
    dt = time.perf_counter() - t0
    return {"seconds": dt, "tokens_per_s": iterations * B * T / dt,
            "losses": [float(x) for x in losses],
            "n_params": sum(p.numel() for p in tree_leaves(params))}


def run_synthetic(args) -> dict:
    """``--mode synthetic``: the reference's profiling path, ``--n-envs``
    rows of ``--t-max`` tokens for ``--iterations`` steps, and its log
    line."""
    if args.arch == "paac_vector":
        raise SystemExit("--mode synthetic trains a token arch's trajectory "
                         "step: give --arch one of the token archs")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = synthetic_steps(cfg, args.n_envs, args.t_max, args.iterations,
                          args.seed, args.device)
    log.info("synthetic: %d iters, %.1f tokens/s, loss=%.4f",
             args.iterations, out["tokens_per_s"], out["losses"][-1])
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED_ARCHS + ["paac_vector"],
                    default="mamba2-370m",
                    help="a token arch (default mamba2-370m, the "
                    "reference's) or paac_vector, the vector policy on the "
                    "raw token ids")
    ap.add_argument("--mode", choices=("rl", "synthetic"), default="rl")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--n-envs", type=int, default=16)
    ap.add_argument("--t-max", type=int, default=8)
    ap.add_argument("--ctx", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--checkpoint", default="",
                    help="save the final params here (a directory) after "
                    "the epochs")
    ap.add_argument("--pipeline", action="store_true",
                    help="use the asynchronous actor/learner pipeline backend")
    ap.add_argument("--queue-depth", type=int, default=2,
                    help="trajectory queue depth (max rollouts in flight)")
    ap.add_argument("--rho-bar", type=float, default=1.0,
                    help="importance-weight clip for stale rollouts (V-trace ρ̄)")
    ap.add_argument("--c-bar", type=float, default=1.0,
                    help="V-trace c̄: clip on the backward-propagation product")
    ap.add_argument("--num-actors", type=int, default=1,
                    help="actor replicas feeding the learner (env axis split)")
    ap.add_argument("--rollout-plane",
                    choices=("auto", "device", "host", "mesh"),
                    default="auto",
                    help="trajectory queue plane: auto, device, host or "
                    "mesh (one actor lane a device, sharded learner)")
    ap.add_argument("--mesh", type=int, default=1,
                    help="mesh rollout plane over this many devices (with "
                    "--device cpu, lanes that share the CPU)")
    ap.add_argument("--algo", choices=("paac", "dqn"), default="paac",
                    help="agent family: on-policy PAAC (V-trace under the "
                    "pipeline) or value-based DQN (synchronous, with its own "
                    "replay buffer)")
    ap.add_argument("--replay", action="store_true",
                    help="pipeline: the sampled ReplayRing plane (actors "
                    "never block; the learner samples retained rollouts)")
    ap.add_argument("--replay-capacity", type=int, default=64,
                    help="ReplayRing capacity in resident rollouts")
    ap.add_argument("--replay-batch", type=int, default=1,
                    help="rollouts sampled per learner update")
    ap.add_argument("--prioritized", action="store_true",
                    help="TD-error-weighted replay sampling (else uniform)")
    ap.add_argument("--actor-backend", choices=("thread", "process"),
                    default="thread",
                    help="where actor replicas run: threads, or spawned "
                    "worker subprocesses over shared memory (implies "
                    "--host-env)")
    ap.add_argument("--host-env", action="store_true",
                    help="drive a HostEnvPool of GIL-holding Python-bound "
                    "emulators (the paper's n_w worker threads)")
    ap.add_argument("--env-spin", type=int, default=2000,
                    help="pure-Python work per host-env step")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace-event JSON of the run's spans "
                    "here (open in Perfetto); pipeline backend only")
    ap.add_argument("--metrics-jsonl", default="",
                    help="append a JSONL metrics heartbeat line here every "
                    "tick; pipeline backend only")
    ap.add_argument("--sanitize", default="",
                    help="arm runtime sanitizers (comma-separated: 'locks' "
                    "= lock-order cycle/hazard detector, 'transfers' = "
                    "host-sync guard over the steady state and the "
                    "in-place publish probe); pipeline backend only")
    ap.add_argument("--stall-timeout", type=float, default=0.0,
                    help="stall watchdog window in seconds (0 = off): log "
                    "each party's blocked stage when progress stops; "
                    "pipeline backend only")
    ap.add_argument("--elastic", action="store_true",
                    help="supervise actor replicas: respawn crashed actors "
                    "under --restart-budget, then degrade to fewer actors "
                    "(default is fail-fast)")
    ap.add_argument("--restart-budget", type=int, default=1,
                    help="respawns allowed per actor slot (with --elastic)")
    ap.add_argument("--restart-backoff", type=float, default=0.05,
                    help="base respawn backoff in seconds (with --elastic)")
    ap.add_argument("--lease-timeout", type=float, default=60.0,
                    help="learner-side param-lease timeout: error naming the "
                    "holding party when a lease is never released")
    ap.add_argument("--fault-kill", action="append", default=[],
                    metavar="SLOT:AFTER[:MODE]",
                    help="deterministic fault injection: kill actor slot "
                    "SLOT after AFTER produced rollouts; MODE is 'error' "
                    "(raise in the replica, default) or 'exit' (hard process "
                    "exit, process backend). Repeatable.")
    ap.add_argument("--fault-stall-learner", action="append", default=[],
                    metavar="ITER:SECONDS",
                    help="deterministic fault injection: sleep SECONDS in "
                    "the learner loop before update ITER. Repeatable.")
    ap.add_argument("--checkpoint-dir", default="",
                    help="directory for the pipeline's full-state "
                    "checkpoints (params, opt state, generators, counters)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save a pipeline checkpoint every N learner "
                    "updates (0 = off; requires --checkpoint-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint in --checkpoint-dir "
                    "and run only the remaining iterations (bitwise "
                    "continuation on the thread backend's FIFO planes)")
    return ap


def main(argv=None):
    """``--mode rl``: one ``RunResult`` an epoch; ``--mode synthetic``: the
    dict of ``synthetic_steps``."""
    args = build_parser().parse_args(argv)
    if args.mode == "synthetic":
        return run_synthetic(args)
    _, results = run_rl(args)
    return results


if __name__ == "__main__":
    main()

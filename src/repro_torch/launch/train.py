"""Training launcher — the port of ``repro/launch/train.py``.

``--mode rl`` runs full PAAC RL (Algorithm 1) against the k-back echo
``TokenEnv`` — rollout with the current policy, synchronous update — on
the card, or on the CPU with ``--device cpu`` (without a CUDA device the
default raises). ``--algo dqn`` selects the value-based agent: the
synchronous DQN with its own replay buffer. ``--host-env`` swaps the
TokenEnv for the paper's host env plane: a ``HostEnvPool`` of GIL-holding
Python emulators (``PyBoundEnv``, ``--env-spin`` pure-Python work a step,
16-wide observations, 3 actions) stepped by up to 8 worker threads.
``--pipeline`` swaps the synchronous ``ParallelRL`` backend for the
asynchronous actor/learner pipeline (``repro_torch.pipeline.PipelinedRL``)
with thread actors: ``--num-actors`` replicas (the env axis split between
them) collect rollouts while the learner consumes earlier ones, with
``--queue-depth`` bounding staleness and ``--rho-bar``/``--c-bar`` the
V-trace clips (K2) on the off-policy importance correction.
``--rollout-plane`` picks the trajectory plane: the device ring (tensor
envs), or the host staging queue (``--host-env`` pools; on the TokenEnv
the GA3C-style baseline). ``--trace`` writes a Chrome trace of the
pipeline's spans, ``--metrics-jsonl`` a JSONL liveness heartbeat, and
``--stall-timeout`` arms the stall watchdog, which names the stage each
party is blocked in when progress stops. The synchronous PAAC update
computes its n-step returns through K1.

The parser takes every flag of the reference, with its defaults, plus
``--device``. Every ``SystemExit`` of the reference's flag validation comes
in the reference's order with its text. What the port does not run yet
raises ``NotImplementedError`` naming its ROADMAP Queue 1 item: the token
archs and ``--mode synthetic`` (their training pass needs a backward
through K3 and K6: item 11), ``--actor-backend process``, ``--replay``,
``--elastic``, ``--fault-*``, ``--checkpoint*`` and ``--resume`` (item
10), ``--sanitize`` (item 13), and ``--mesh`` > 1 and ``--rollout-plane
mesh`` (item 14). So ``--arch`` defaults to ``paac_vector``, the vector
policy acting on the raw observations (the reference's default,
``mamba2-370m``, waits for item 11).

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --iterations 50
    PYTHONPATH=src python -m repro_torch.launch.train --iterations 50 \\
        --pipeline --num-actors 4 --n-envs 16
    PYTHONPATH=src python -m repro_torch.launch.train --iterations 50 \\
        --algo dqn
    PYTHONPATH=src python -m repro_torch.launch.train --iterations 50 \\
        --host-env --n-envs 32 --pipeline --metrics-jsonl hb.jsonl
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --iterations 4 --n-envs 4
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

from repro_torch.configs import PipelineConfig, get_config
from repro_torch.core.agents import (DQNAgent, DQNConfig, PAACAgent,
                                     PAACConfig)
from repro_torch.core.framework import ParallelRL, RunResult
from repro_torch.device import resolve_device
from repro_torch.envs import TokenEnv, py_bound_spec
from repro_torch.optim import constant
from repro_torch.pipeline import PipelinedRL
from repro_torch.utils import get_logger

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


def _refuse_unported(args) -> None:
    """``NotImplementedError`` for each setting the port does not run yet,
    naming the ROADMAP Queue 1 item that ports it."""
    unported = [
        (args.arch != "paac_vector", f"--arch {args.arch} (the token archs' "
         "training pass, which needs a backward through K3 and K6) is item "
         "11"),
        (args.actor_backend == "process", "--actor-backend process is item "
         "10"),
        (args.replay, "--replay (the replay plane) is item 10"),
        (args.elastic or args.fault_kill or args.fault_stall_learner,
         "--elastic and --fault-* (the supervisor and fault injection) are "
         "item 10"),
        (args.checkpoint or args.checkpoint_dir or args.checkpoint_every
         or args.resume, "--checkpoint, --checkpoint-dir, --checkpoint-every "
         "and --resume (checkpoints) are item 10"),
        (args.sanitize, "--sanitize (the runtime sanitizers) is item 13"),
        (args.mesh > 1 or args.rollout_plane == "mesh", "--mesh > 1 and "
         "--rollout-plane mesh (the mesh plane) are item 14"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(
                f"repro_torch.launch.train: {what} of ROADMAP Queue 1")


def run_rl(args) -> Tuple[object, List[RunResult]]:
    """Build and run the backend ``args`` select. Returns the backend and
    one ``RunResult`` an epoch."""
    _refuse_invalid(args)
    _refuse_unported(args)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.host_env:
        # the GIL-holding external-emulator pool (repro_torch.envs.pyemu)
        spec = py_bound_spec(args.n_envs, obs_dim=16, spin=args.env_spin,
                             n_workers=min(8, args.n_envs), device=str(dev))
        cfg = cfg.replace(obs_shape=spec.obs_shape, num_actions=3)
        env = spec if args.pipeline else spec.build()
    else:
        env = TokenEnv(args.n_envs, vocab=min(cfg.vocab_size, 64),
                       ctx=args.ctx, k=2, horizon=64, device=dev)
        # the vector policy acts on the raw token ids
        cfg = cfg.replace(num_actions=env.vocab, obs_shape=env.obs_shape)
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
                                    lease_timeout_s=args.lease_timeout,
                                    trace_path=args.trace,
                                    metrics_jsonl=args.metrics_jsonl,
                                    stall_timeout_s=args.stall_timeout))
    else:
        try:
            rl = ParallelRL(env, agent, lr_schedule=constant(args.lr),
                            seed=args.seed, device=dev)
        except BaseException:
            if args.host_env:
                env.close()
            raise
    results = []
    try:
        for epoch in range(args.epochs):
            res = rl.run(args.iterations,
                         log_every=max(args.iterations // 4, 1))
            log.info(
                "epoch %d steps=%d mean_reward/iter=%.3f tps=%.0f%s",
                epoch, res.steps, res.mean_metrics.get("reward_sum", 0.0),
                res.timesteps_per_sec,
                (f" staleness={res.mean_metrics.get('staleness', 0.0):.1f}"
                 f" actor_idle={res.actor_idle_s:.2f}s"
                 f" learner_idle={res.learner_idle_s:.2f}s"
                 if args.pipeline else ""))
            results.append(res)
    finally:
        if hasattr(rl, "close"):
            rl.close()  # the pools PipelinedRL built from the spec
        elif args.host_env:
            env.close()
    return rl, results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED_ARCHS + ["paac_vector"],
                    default="paac_vector",
                    help="paac_vector (the token archs are ROADMAP Queue 1 "
                    "item 11)")
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
    ap.add_argument("--checkpoint", default="")
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
                    help="trajectory queue plane: auto, device or host "
                    "(mesh is ROADMAP Queue 1 item 14)")
    ap.add_argument("--mesh", type=int, default=1,
                    help="mesh rollout plane over this many devices (ROADMAP "
                    "Queue 1 item 14)")
    ap.add_argument("--algo", choices=("paac", "dqn"), default="paac",
                    help="agent family: on-policy PAAC (V-trace under the "
                    "pipeline) or value-based DQN (synchronous, with its own "
                    "replay buffer)")
    ap.add_argument("--replay", action="store_true",
                    help="pipeline: the sampled ReplayRing plane (ROADMAP "
                    "Queue 1 item 10)")
    ap.add_argument("--replay-capacity", type=int, default=64,
                    help="ReplayRing capacity in resident rollouts")
    ap.add_argument("--replay-batch", type=int, default=1,
                    help="rollouts sampled per learner update")
    ap.add_argument("--prioritized", action="store_true",
                    help="TD-error-weighted replay sampling (else uniform)")
    ap.add_argument("--actor-backend", choices=("thread", "process"),
                    default="thread",
                    help="where actor replicas run: threads (process is "
                    "ROADMAP Queue 1 item 10)")
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
                    help="runtime sanitizers (ROADMAP Queue 1 item 13)")
    ap.add_argument("--stall-timeout", type=float, default=0.0,
                    help="stall watchdog window in seconds (0 = off): log "
                    "each party's blocked stage when progress stops; "
                    "pipeline backend only")
    ap.add_argument("--elastic", action="store_true",
                    help="supervise actor replicas (ROADMAP Queue 1 item 10)")
    ap.add_argument("--restart-budget", type=int, default=1,
                    help="respawns allowed per actor slot (with --elastic)")
    ap.add_argument("--restart-backoff", type=float, default=0.05,
                    help="base respawn backoff in seconds (with --elastic)")
    ap.add_argument("--lease-timeout", type=float, default=60.0,
                    help="learner-side param-lease timeout: error naming the "
                    "holding party when a lease is never released")
    ap.add_argument("--fault-kill", action="append", default=[],
                    metavar="SLOT:AFTER[:MODE]",
                    help="fault injection (ROADMAP Queue 1 item 10)")
    ap.add_argument("--fault-stall-learner", action="append", default=[],
                    metavar="ITER:SECONDS",
                    help="fault injection (ROADMAP Queue 1 item 10)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="pipeline checkpoints (ROADMAP Queue 1 item 10)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="pipeline checkpoints (ROADMAP Queue 1 item 10)")
    ap.add_argument("--resume", action="store_true",
                    help="pipeline checkpoints (ROADMAP Queue 1 item 10)")
    return ap


def main(argv=None) -> List[RunResult]:
    args = build_parser().parse_args(argv)
    if args.mode != "rl":
        raise NotImplementedError(
            "repro_torch.launch.train: --mode synthetic (the token archs' "
            "trajectory train step) is item 11 of ROADMAP Queue 1")
    _, results = run_rl(args)
    return results


if __name__ == "__main__":
    main()

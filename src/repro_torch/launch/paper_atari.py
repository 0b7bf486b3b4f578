"""The paper's setting: the arch_nips or arch_nature CNN on an 84×84×4
pixel environment with the §5.1 pipeline (frame stack, action repeat,
no-op starts) and §5.1 hyperparameters (n_e=32, t_max=5, RMSProp decay .99
eps .1, clip 40, lr 0.0007·n_e) — the port of ``examples/paper_atari.py``.

Runs on the card unless ``--device cpu`` is given; without a CUDA device
the default raises. It runs exactly ``--iters`` iterations, in epochs of up
to 25, and prints one line an epoch.

``--pipeline`` runs the asynchronous actor/learner backend
(``repro_torch.pipeline.PipelinedRL``) over the same env, agent,
optimizer and lr, with ``repro.launch.train``'s flags and defaults:
``--num-actors`` replicas (the env axis split between them) collect while
the learner consumes earlier rollouts, ``--queue-depth`` bounds how far
they run ahead, and ``--rho-bar``/``--c-bar`` are the V-trace clips (K2;
``inf`` for both is the synchronous update through K1). ``--trace PATH``
writes a Chrome trace of every epoch's actor, ring and learner spans (each
epoch overwrites the last). The epoch line then adds ``staleness=``,
``actor_idle=`` and ``learner_idle=``.

    PYTHONPATH=src python -m repro_torch.launch.paper_atari \\
        --arch paac_nature --n-envs 32 --iters 50
    PYTHONPATH=src python -m repro_torch.launch.paper_atari \\
        --arch paac_nature --n-envs 32 --iters 50 --pipeline
    PYTHONPATH=src python -m repro_torch.launch.paper_atari \\
        --device cpu --n-envs 4 --iters 2 --pipeline
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Union

from repro_torch.configs import PipelineConfig, get_config
from repro_torch.core.agents import PAACAgent, PAACConfig
from repro_torch.core.framework import ParallelRL, RunResult
from repro_torch.device import resolve_device
from repro_torch.envs import AtariLike, FrameStack
from repro_torch.optim import constant
from repro_torch.pipeline import PipelinedRL

EPOCH = 25  # iterations a printed line


def build(arch: str = "paac_nips", n_envs: int = 32, seed: int = 0,
          device="cuda", pipeline: Optional[PipelineConfig] = None
          ) -> Union[ParallelRL, PipelinedRL]:
    """The paper's setting on ``device``, ready to ``run``: ``ParallelRL``,
    or ``PipelinedRL`` under ``pipeline`` when one is given."""
    dev = resolve_device(device)
    env = FrameStack(AtariLike(n_envs, device=dev), n=4)
    cfg = get_config(arch).replace(obs_shape=env.obs_shape,
                                   num_actions=env.num_actions)
    agent = PAACAgent(cfg, PAACConfig(gamma=0.99, entropy_beta=0.01, t_max=5))
    kw = dict(optimizer="rmsprop", lr_schedule=constant(0.0007 * n_envs),
              seed=seed, device=dev)
    if pipeline is not None:
        return PipelinedRL(env, agent, pipeline=pipeline, **kw)
    return ParallelRL(env, agent, **kw)


def main(argv=None) -> List[RunResult]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--n-envs", type=int, default=32)
    ap.add_argument("--arch", default="paac_nips",
                    choices=("paac_nips", "paac_nature"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipeline", action="store_true",
                    help="use the asynchronous actor/learner pipeline backend")
    ap.add_argument("--queue-depth", type=int, default=2,
                    help="trajectory ring depth (max rollouts in flight)")
    ap.add_argument("--rho-bar", type=float, default=1.0,
                    help="importance-weight clip for stale rollouts (V-trace ρ̄)")
    ap.add_argument("--c-bar", type=float, default=1.0,
                    help="V-trace c̄: clip on the backward-propagation product")
    ap.add_argument("--num-actors", type=int, default=1,
                    help="actor replicas feeding the learner (env axis split)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace-event JSON of the run's spans "
                    "here (open in Perfetto); pipeline backend only")
    args = ap.parse_args(argv)
    if args.trace and not args.pipeline:
        ap.error("--trace observes the pipeline: it needs --pipeline")

    pipeline = (PipelineConfig(queue_depth=args.queue_depth,
                               rho_bar=args.rho_bar, c_bar=args.c_bar,
                               num_actors=args.num_actors,
                               trace_path=args.trace)
                if args.pipeline else None)
    rl = build(args.arch, args.n_envs, args.seed, args.device, pipeline)
    results = []
    while len(results) * EPOCH < args.iters:
        res = rl.run(min(EPOCH, args.iters - len(results) * EPOCH))
        print(
            f"epoch {len(results)}: steps={res.steps:7d} "
            f"reward/iter={res.mean_metrics['reward_sum']:+.2f} "
            f"entropy={res.mean_metrics['entropy']:.3f} "
            f"steps/s={res.timesteps_per_sec:,.0f}"
            + (f" staleness={res.mean_metrics['staleness']:.1f}"
               f" actor_idle={res.actor_idle_s:.2f}s"
               f" learner_idle={res.learner_idle_s:.2f}s"
               if args.pipeline else ""), flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main()

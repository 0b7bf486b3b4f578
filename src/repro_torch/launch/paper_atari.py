"""The paper's setting: the arch_nips or arch_nature CNN on an 84×84×4
pixel environment with the §5.1 pipeline (frame stack, action repeat,
no-op starts) and §5.1 hyperparameters (n_e=32, t_max=5, RMSProp decay .99
eps .1, clip 40, lr 0.0007·n_e) — the port of ``examples/paper_atari.py``.

Runs on the card unless ``--device cpu`` is given; without a CUDA device
the default raises. It runs exactly ``--iters`` iterations, in epochs of up
to 25, and prints one line an epoch.

    PYTHONPATH=src python -m repro_torch.launch.paper_atari \\
        --arch paac_nature --n-envs 32 --iters 50
    PYTHONPATH=src python -m repro_torch.launch.paper_atari \\
        --device cpu --n-envs 4 --iters 2
"""
from __future__ import annotations

import argparse
from typing import List

from repro_torch.configs import get_config
from repro_torch.core.agents import PAACAgent, PAACConfig
from repro_torch.core.framework import ParallelRL, RunResult
from repro_torch.device import resolve_device
from repro_torch.envs import AtariLike, FrameStack
from repro_torch.optim import constant

EPOCH = 25  # iterations a printed line


def build(arch: str = "paac_nips", n_envs: int = 32, seed: int = 0,
          device="cuda") -> ParallelRL:
    """The paper's setting on ``device``, ready to ``run``."""
    dev = resolve_device(device)
    env = FrameStack(AtariLike(n_envs, device=dev), n=4)
    cfg = get_config(arch).replace(obs_shape=env.obs_shape,
                                   num_actions=env.num_actions)
    agent = PAACAgent(cfg, PAACConfig(gamma=0.99, entropy_beta=0.01, t_max=5))
    return ParallelRL(env, agent, optimizer="rmsprop",
                      lr_schedule=constant(0.0007 * n_envs), seed=seed,
                      device=dev)


def main(argv=None) -> List[RunResult]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--n-envs", type=int, default=32)
    ap.add_argument("--arch", default="paac_nips",
                    choices=("paac_nips", "paac_nature"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    rl = build(args.arch, args.n_envs, args.seed, args.device)
    results = []
    while len(results) * EPOCH < args.iters:
        res = rl.run(min(EPOCH, args.iters - len(results) * EPOCH))
        print(
            f"epoch {len(results)}: steps={res.steps:7d} "
            f"reward/iter={res.mean_metrics['reward_sum']:+.2f} "
            f"entropy={res.mean_metrics['entropy']:.3f} "
            f"steps/s={res.timesteps_per_sec:,.0f}", flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main()

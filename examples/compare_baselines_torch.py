"""The paper's stability argument (§1, §3) on the PyTorch port: PAAC
against the two failure modes it eliminates — A3C-sim (stale gradients)
and GA3C-sim (policy lag), each with a parameter copy 8 updates behind —
and DQN, the off-policy member of the framework family, on Catch.

The metric is the reward an iteration over ``--final-iters`` iterations
after a fixed training budget of ``--iters``. The paper's qualitative
claim is PAAC >= the lagged variants; the script reports the order and
asserts none.

    PYTHONPATH=src python examples/compare_baselines_torch.py   # the card
    PYTHONPATH=src python examples/compare_baselines_torch.py --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict

from repro_torch.configs import get_config
from repro_torch.core import ParallelRL
from repro_torch.core.agents import (DQNAgent, DQNConfig, LaggedConfig,
                                     LaggedPAACAgent, PAACAgent, PAACConfig)
from repro_torch.envs import Catch
from repro_torch.optim import constant


def run(iters: int = 300, n_e: int = 32, delay: int = 8,
        final_iters: int = 40, device="cuda") -> Dict[str, float]:
    """Each agent's reward an iteration after ``iters`` iterations."""
    env = Catch(n_e, rows=6, cols=5, device=device)
    cfg = get_config("paac_vector").replace(obs_shape=env.obs_shape,
                                            num_actions=env.num_actions)
    lagged = LaggedConfig(t_max=5, delay=delay)
    agents = {
        "paac": (PAACAgent(cfg, PAACConfig(t_max=5)), "rmsprop", 0.01),
        "a3c_sim_stale_grad": (LaggedPAACAgent(cfg, lagged, "grad"),
                               "rmsprop", 0.01),
        "ga3c_sim_policy_lag": (LaggedPAACAgent(cfg, lagged, "act"),
                                "rmsprop", 0.01),
        "dqn": (DQNAgent(cfg, DQNConfig(t_max=5, batch_size=64,
                                        eps_steps=500)), "adam", 1e-3),
    }
    scores = {}
    for name, (agent, opt, lr) in agents.items():
        rl = ParallelRL(env, agent, optimizer=opt, lr_schedule=constant(lr),
                        seed=0, device=device)
        rl.run(iters)
        scores[name] = rl.run(final_iters).mean_metrics["reward_sum"]
    return scores


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--n-envs", type=int, default=32)
    ap.add_argument("--final-iters", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    scores = run(args.iters, args.n_envs, final_iters=args.final_iters,
                 device=args.device)
    print("final reward/iteration (higher is better):")
    for name, score in sorted(scores.items(), key=lambda kv: -kv[1]):
        print(f"  {name:24s} {score:+.3f}")
    return scores


if __name__ == "__main__":
    main()

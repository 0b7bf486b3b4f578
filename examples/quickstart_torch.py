"""Quickstart of the PyTorch port: PAAC (paper Algorithm 1) on GridWorld,
then the asynchronous pipeline's two queue planes pinned to it.

Part 1 trains synchronously with ``ParallelRL``. Part 2 runs the same
training through the pipeline's device-resident ring and through its host
staging queue (forced onto the tensor env: the GA3C-style baseline, whose
trajectories go to page-locked host sets and back) in lockstep settings
(depth 1, the actor waits for fresh params, infinite V-trace clips) and
asserts that each reproduces the synchronous metrics exactly: the planes
differ in overlap and placement, never in math. The reference's mesh
sub-rings are not ported yet (ROADMAP Queue 1 item 14); the script says
so and skips them.

    PYTHONPATH=src python examples/quickstart_torch.py             # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.configs import PipelineConfig, get_config
from repro_torch.core import ParallelRL
from repro_torch.core.agents import PAACAgent, PAACConfig
from repro_torch.envs import GridWorld
from repro_torch.optim import constant
from repro_torch.pipeline import PipelinedRL

INF = float("inf")
SEED = 7
SHARED = ("loss", "reward_sum", "policy_loss", "value_loss", "entropy")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n-envs", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--iters", type=int, default=50,
                    help="iterations an epoch of part 1")
    ap.add_argument("--lock-iters", type=int, default=20,
                    help="iterations of part 2")
    args = ap.parse_args(argv)
    dev = args.device

    # -- part 1: the paper's synchronous framework --------------------------
    # n_e parallel environments — one batched tensor program (paper §3)
    env = GridWorld(n_envs=args.n_envs, size=5, device=dev)
    cfg = get_config("paac_vector").replace(obs_shape=env.obs_shape,
                                            num_actions=env.num_actions)

    def fresh_agent():
        return PAACAgent(cfg, PAACConfig(t_max=5, gamma=0.99,
                                         entropy_beta=0.01))

    rl = ParallelRL(env, fresh_agent(), optimizer="rmsprop",
                    lr_schedule=constant(0.01), device=dev)
    for epoch in range(args.epochs):
        res = rl.run(args.iters)
        print(f"epoch {epoch}: steps={res.steps:6d} "
              f"reward/iter={res.mean_metrics['reward_sum']:+.3f} "
              f"episodes={res.episodes:.0f} "
              f"steps/s={res.timesteps_per_sec:,.0f}")

    # -- part 2: both queue planes, pinned to the synchronous run ------------
    kw = dict(optimizer="rmsprop", lr_schedule=constant(0.01),
              seed=SEED, device=dev)
    sync = ParallelRL(GridWorld(n_envs=args.n_envs, size=5, device=dev),
                      fresh_agent(), **kw).run(args.lock_iters)
    print(f"{'sync':>10}: reward/iter={sync.mean_metrics['reward_sum']:+.3f} "
          f"loss={sync.mean_metrics['loss']:+.5f} "
          f"steps/s={sync.timesteps_per_sec:,.0f}")
    planes = {}
    for plane in ("device", "host"):
        prl = PipelinedRL(GridWorld(n_envs=args.n_envs, size=5, device=dev),
                          fresh_agent(),
                          pipeline=PipelineConfig(queue_depth=1, lockstep=True,
                                                  rho_bar=INF, c_bar=INF,
                                                  rollout_plane=plane), **kw)
        res_p = planes[plane] = prl.run(args.lock_iters)
        print(f"{plane:>10}: "
              f"reward/iter={res_p.mean_metrics['reward_sum']:+.3f} "
              f"loss={res_p.mean_metrics['loss']:+.5f} "
              f"steps/s={res_p.timesteps_per_sec:,.0f}")
        for k in SHARED:
            if res_p.mean_metrics[k] != sync.mean_metrics[k]:
                raise AssertionError(f"{plane} plane: mean {k} "
                                     f"{res_p.mean_metrics[k]!r} != sync "
                                     f"{sync.mean_metrics[k]!r}")
    print("the device ring and the host queue reproduce the synchronous "
          "metrics bit for bit")
    print(f"{'mesh':>10}: not ported yet (ROADMAP Queue 1 item 14)")
    return res, sync, planes["device"], planes["host"]

if __name__ == "__main__":
    main()

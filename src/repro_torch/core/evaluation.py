"""The paper's evaluation protocol (Table 1 caption), the port of
``repro/core/evaluation.py``:

    "Scores are measured from the best performing actor out of three, and
     averaged over 30 runs with up to 30 no-op actions start condition."

``evaluate`` runs ``n_runs`` complete episodes per actor seed with a greedy
(or sampled) policy, the environments applying their own random no-op
starts on reset (``AtariLike`` builds §5.1's 1–30 no-ops in), and reports
the per-seed mean returns plus the paper's best-of-k statistic.

Each actor seed has its own generator, derived from the caller's, which
draws that seed's resets, env steps and (when not greedy) actions. A batch
of ``n_envs`` episodes runs for ``max_steps`` steps, or until every episode
has ended: that is checked every ``CHECK_EVERY`` steps, so the host waits
for the card once in that many steps and not in every one. An episode's
return stops growing at its first end, so stopping then changes nothing.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.utils.sampling import categorical, seeded_generators

CHECK_EVERY = 32  # steps between the checks for a batch's last episode end


@torch.no_grad()
def evaluate(
    act_fn: Callable,  # (params, obs) -> (logits, value)
    env,
    params,
    generator: torch.Generator,
    *,
    n_runs: int = 30,
    n_actor_seeds: int = 3,
    max_steps: int = 1_000,
    greedy: bool = True,
    start_states: Optional[Sequence[Dict]] = None,
) -> Dict:
    """Paper-protocol evaluation. Returns {best_of_k, mean, per_seed}.

    ``start_states``, if given, replaces the fresh resets: the env state
    each batch starts from, seed by seed and batch by batch (a test seam
    that replays another run's episodes)."""
    root = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device))
    starts = iter(start_states) if start_states is not None else None
    E = env.n_envs

    def run_batch(env_state, gen):
        """All n_envs episodes to their first end (or max_steps)."""
        obs = env.observe(env_state)
        ep_ret = torch.zeros((E,), device=env.device)
        done_seen = torch.zeros((E,), device=env.device)
        for t in range(max_steps):
            logits, _ = act_fn(params, obs)
            action = (logits.argmax(dim=-1) if greedy
                      else categorical(logits, gen))
            env_state, obs, reward, done = env.step(env_state, action, gen)
            ep_ret = ep_ret + reward * (1.0 - done_seen)
            done_seen = torch.maximum(done_seen, done.to(torch.float32))
            if (t + 1) % CHECK_EVERY == 0 and bool(done_seen.all()):
                break
        return ep_ret

    per_seed: List[float] = []
    for gen in seeded_generators(root, n_actor_seeds, env.device):
        returns: List[float] = []
        while len(returns) < n_runs:
            env_state = env.reset(gen) if starts is None else next(starts)
            ep_ret = run_batch(env_state, gen)
            take = min(E, n_runs - len(returns))
            returns.extend(float(r) for r in ep_ret[:take].tolist())
        per_seed.append(sum(returns) / len(returns))

    return {
        "best_of_k": max(per_seed),  # the paper's Table-1 statistic
        "mean": sum(per_seed) / len(per_seed),
        "per_seed": per_seed,
    }

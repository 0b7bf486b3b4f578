"""End-to-end driver of the PyTorch port: train a ~100M-parameter
transformer policy with PAAC on the token environment for a few hundred
steps, the port of ``examples/train_llm_rl.py``.

The policy is a qwen2-family backbone scaled to ~100M params; the
environment is the k-back echo game (``repro_torch.envs.TokenEnv``) — the
action space is the vocabulary, so the rollout is batched autoregressive
acting, the paper's master/worker schedule applied to an LLM. Every
learning pass runs K3 with its backward in each attention layer and K1 for
the n-step returns.

    PYTHONPATH=src python examples/train_llm_rl_torch.py --iters 300
    PYTHONPATH=src python examples/train_llm_rl_torch.py --smoke   # tiny
    PYTHONPATH=src python examples/train_llm_rl_torch.py --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.core import ParallelRL
from repro_torch.core.agents import PAACAgent, PAACConfig
from repro_torch.envs import TokenEnv
from repro_torch.optim import constant
from repro_torch.utils.tree import tree_leaves

VOCAB = 64


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--n-envs", type=int, default=8)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = get_config("qwen2-7b").reduced().replace(
            num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
            head_dim=32, d_ff=256, vocab_size=VOCAB, num_actions=VOCAB)
    else:
        # ~100M params: 12L, d_model 768, d_ff 2048
        cfg = get_config("qwen2-7b").replace(
            num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=VOCAB, num_actions=VOCAB,
            param_dtype="float32", compute_dtype="float32", remat="none")

    env = TokenEnv(args.n_envs, vocab=VOCAB, ctx=16, k=2, horizon=32,
                   device=args.device)
    agent = PAACAgent(cfg, PAACConfig(t_max=4, entropy_beta=0.005))
    rl = ParallelRL(env, agent, optimizer="adam", lr_schedule=constant(1e-3),
                    device=args.device)
    n_params = sum(p.numel() for p in tree_leaves(rl.params))
    print(f"policy params: {n_params / 1e6:.1f}M ({cfg.num_layers}L "
          f"d={cfg.d_model})")

    steps_per_iter = args.n_envs * 4
    chunk = min(25, args.iters)
    results = []
    for epoch in range((args.iters + chunk - 1) // chunk):
        t0 = time.time()
        res = rl.run(chunk)
        results.append(res)
        r = res.mean_metrics["reward_sum"] / steps_per_iter
        print(f"iter {(epoch + 1) * chunk:4d}: reward/step={r:.3f} "
              f"(random={1 / VOCAB:.3f}, optimal=1.0) "
              f"loss={res.mean_metrics['loss']:.4f} "
              f"steps/s={res.timesteps_per_sec:,.0f} "
              f"[{time.time() - t0:.1f}s]")
    return results


if __name__ == "__main__":
    main()

"""The plain reference of one PAAC training cell, in plain PyTorch.

It imports nothing of the program. From the run's seed it works out
again everything the program derives from it: the three random streams
(parameters, environments, acting), the initial weights, and every frame
of the 84x84 "CatchPixels" game behind the paper's pre-processing (action
repeat, 1-30 no-op starts, a stack of 4 frames, auto-reset). Then it runs
the first ``steps`` iterations of Algorithm 1 (arXiv:1705.04862) with the
paper's losses, returns and RMSProp, in ``dtype`` (float64 as the
reference; float32 when it stands in for the program as the control).

Rollout ``i`` is acted with the parameters of its behaviour version
``versions[i]`` (the parameters after that many updates; by default ``i``,
the synchronous schedule), and update ``i`` takes its bootstrap value and
its importance weights under the learner's parameters after ``i`` updates:
a pipelined actor that acts behind the learner makes the weights differ
from 1, and V-trace clips them. Where the program's sampled actions are
given (``follow``), the reference takes them in place of its own draws and
measures, for each, how far the chosen action's Gumbel-perturbed logit
lies below the best one under the reference's own logits: the actions are
the program's outputs and are judged, not trusted.

Where the program's weights after each update are given (``states``), the
reference follows them step by step: update ``i`` starts from the
program's weights after update ``i - 1`` (the seed's own for the first,
which the check holds equal to the program's), and a rollout of version
``v`` is acted with the program's weights after ``v`` updates. Each
compared update is then one step of rounding away from the program's: at
the cells' learning rate (0.0007 x 256) a ReLU input within float32's
rounding of 0 that flips in one step grows over the next ones, and a free
run would compare that growth, not the program. The RMSProp accumulator is
the reference's own throughout.

``fault`` plants one of the faults a training cell can have, for the
calibration of the limits and the tests: ``"half"`` takes the loss over
half of the batch, ``"action"`` alters one sampled action, ``"frozen"``
returns the parameters unchanged from each step, ``"stale"`` acts every
rollout with the initial parameters (an actor that never takes up a
published set), ``"rho_one"`` gives V-trace importance weights of 1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

LOSS_TERMS = ("loss", "policy_loss", "value_loss", "entropy", "rho_mean")
SIZE = 84
PADDLE_W = 8
BALL = 3
ROW_BOTTOM = SIZE - 4
FALL = 2


def seed_generators(seed: int, n: int, device) -> List[torch.Generator]:
    """``n`` generators on ``device`` from one root seed: numpy's
    ``SeedSequence(seed).spawn(n)``, one 64-bit state each."""
    gens = []
    for ss in np.random.SeedSequence(seed).spawn(n):
        g = torch.Generator(device=device)
        g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
        gens.append(g)
    return gens


def _bounce(col, vx):
    col = col + vx
    vx = torch.where((col <= BALL) | (col >= SIZE - BALL), -vx, vx)
    return col.clamp(BALL, SIZE - BALL), vx


class CatchPixels:
    """``n`` games at once: int32 physics, frames of ``dtype``, a stack of
    ``stack`` frames channels last, finished games restarted in the step
    that ends them. Every draw comes from the generator handed in, in a
    fixed order that does not depend on the data."""

    def __init__(self, n: int, *, lives: int, action_repeat: int,
                 max_noops: int, stack: int, device, dtype):
        self.n, self.lives, self.repeat = n, lives, action_repeat
        self.max_noops, self.stack, self.dtype = max_noops, stack, dtype
        self.device = torch.device(device)
        self.idx = torch.arange(SIZE, dtype=torch.int32, device=self.device)
        col, vx = torch.meshgrid(
            torch.arange(BALL, SIZE - BALL + 1, dtype=torch.int32),
            torch.arange(-2, 3, dtype=torch.int32), indexing="ij")
        cols, vxs = [col], [vx]
        for _ in range(max_noops):
            col, vx = _bounce(col, vx)
            cols.append(col)
            vxs.append(vx)
        self.noop_col = torch.stack(cols).to(self.device)
        self.noop_vx = torch.stack(vxs).to(self.device)

    def _randint(self, lo, hi, g):
        return torch.randint(lo, hi, (self.n,), generator=g,
                             device=self.device, dtype=torch.int32)

    def _spawn(self, g):
        col = self._randint(BALL, SIZE - BALL, g)
        vx = self._randint(-2, 3, g)
        return torch.stack([torch.zeros_like(col), col,
                            torch.full_like(col, FALL), vx], dim=1)

    def _fresh(self, g):
        ball = self._spawn(g)
        paddle = self._randint(PADDLE_W, SIZE - PADDLE_W, g)
        noops = self._randint(1, self.max_noops + 1, g)
        n, c0, v0 = noops.long(), (ball[:, 1] - BALL).long(), (ball[:, 3] + 2).long()
        ball = torch.stack([ball[:, 0] + ball[:, 2] * noops,
                            self.noop_col[n, c0, v0], ball[:, 2],
                            self.noop_vx[n, c0, v0]], dim=1)
        lives = torch.full((self.n,), self.lives, dtype=torch.int32,
                           device=self.device)
        return {"ball": ball, "paddle": paddle, "lives": lives}

    def frame(self, s):
        i = self.idx[None, :]
        rows = (i - s["ball"][:, 0, None]).abs() <= BALL // 2
        cols = (i - s["ball"][:, 1, None]).abs() <= BALL // 2
        pcols = (i - s["paddle"][:, None]).abs() <= PADDLE_W
        prows = self.idx >= ROW_BOTTOM
        f = ((rows[:, :, None] & cols[:, None, :])
             | (prows[None, :, None] & pcols[:, None, :]))
        return f.to(self.dtype)

    def reset(self, g):
        s = self._fresh(g)
        f = self.frame(s)
        s["stack"] = f[..., None].expand(f.shape + (self.stack,)).contiguous()
        return s

    def _physics(self, s, action, g):
        paddle = (s["paddle"] + (action - 1) * 3).clamp(PADDLE_W,
                                                         SIZE - PADDLE_W)
        row, col, vy, vx = s["ball"].unbind(1)
        row = row + vy
        col, vx = _bounce(col, vx)
        bottom = row >= ROW_BOTTOM
        caught = bottom & ((col - paddle).abs() <= PADDLE_W)
        reward = torch.where(bottom, torch.where(caught, 1.0, -1.0), 0.0)
        lives = s["lives"] - bottom.to(torch.int32)
        ball = torch.where(bottom[:, None], self._spawn(g),
                           torch.stack([row, col, vy, vx], dim=1))
        return {"ball": ball, "paddle": paddle, "lives": lives}, reward, lives <= 0

    def step(self, s, actions, g):
        """-> (state, obs (n, 84, 84, stack), reward (n,), done (n,))."""
        a = actions.to(torch.int32)
        inner = {k: s[k] for k in ("ball", "paddle", "lives")}
        total = torch.zeros((self.n,), device=self.device)
        done = torch.zeros((self.n,), dtype=torch.bool, device=self.device)
        for _ in range(self.repeat):
            inner, r, d = self._physics(inner, a, g)
            total, done = total + r, done | d
        fresh = self._fresh(g)
        inner = {k: torch.where(done.view((-1,) + (1,) * (v.dim() - 1)),
                                fresh[k], v) for k, v in inner.items()}
        f = self.frame(inner)
        stack = torch.cat([s["stack"][..., 1:], f[..., None]], dim=-1)
        stack = torch.where(done.view(-1, 1, 1, 1),
                            f[..., None].expand(f.shape + (self.stack,)), stack)
        inner["stack"] = stack
        return inner, stack, total.to(self.dtype), done


# -- the network: the paper's CNN and its two heads ---------------------------


def init_params(net: dict, num_actions: int, g: torch.Generator) -> dict:
    """Weights drawn from ``g`` as the seed prescribes: each convolution
    (out, in, k, k) and each dense (in, out) matrix normal with std
    1/sqrt(fan_in), biases 0, in float32."""
    dev = g.device
    in_ch, size = net["obs_shape"][-1], net["obs_shape"][0]
    convs = []
    for feat, kern, stride in net["cnn_spec"]:
        w = torch.randn((feat, in_ch, kern, kern), generator=g, device=dev)
        convs.append({"w": w * (1.0 / math.sqrt(kern * kern * in_ch)),
                      "b": torch.zeros((feat,), device=dev)})
        in_ch, size = feat, (size - kern) // stride + 1

    def dense(i, o, bias):
        p = {"w": torch.randn((i, o), generator=g, device=dev).mul_(
            1.0 / math.sqrt(i))}
        if bias:
            p["b"] = torch.zeros((o,), device=dev)
        return p

    d = net["cnn_dense"]
    trunk = {"convs": convs, "dense": dense(size * size * in_ch, d, True)}
    heads = {"policy": dense(d, num_actions, False), "value": dense(d, 1, True)}
    return {"trunk": trunk, "heads": heads}


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{path: leaf}`` of a nested dict/list tree; a path joins the keys
    and list indices with '/'."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def forward(p: dict, net: dict, obs):
    """obs (B, 84, 84, C) -> (logits (B, A), values (B,))."""
    x = obs.permute(0, 3, 1, 2)
    for conv, (_, _, stride) in zip(p["trunk"]["convs"], net["cnn_spec"]):
        x = F.relu(F.conv2d(x, conv["w"], conv["b"], stride=stride))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    dn = p["trunk"]["dense"]
    h = F.relu(x @ dn["w"] + dn["b"])
    logits = h @ p["heads"]["policy"]["w"]
    value = (h @ p["heads"]["value"]["w"] + p["heads"]["value"]["b"])[:, 0]
    return logits, value


def nstep_returns(r, done, boot, gamma):
    """R_t = r_t + gamma (1 - done_t) R_{t+1}, R_T = boot; (T, E)."""
    out, carry = [], boot
    for t in range(r.shape[0] - 1, -1, -1):
        carry = r[t] + gamma * (~done[t]).to(r.dtype) * carry
        out.append(carry)
    return torch.stack(out[::-1])


def vtrace(r, done, v, boot, rho, gamma, rho_bar, c_bar):
    """V-trace targets and policy-gradient advantages (Espeholt et al.
    2018, eqs. 1-4), (T, E) each."""
    nd = (~done).to(r.dtype)
    rc, c = rho.clamp(max=rho_bar), rho.clamp(max=c_bar)
    v_next = torch.cat([v[1:], boot[None]])
    delta = rc * (r + gamma * nd * v_next - v)
    acc, vs = torch.zeros_like(boot), [None] * r.shape[0]
    for t in range(r.shape[0] - 1, -1, -1):
        acc = delta[t] + gamma * nd[t] * c[t] * acc
        vs[t] = v[t] + acc
    vs = torch.stack(vs)
    vs_next = torch.cat([vs[1:], boot[None]])
    return vs, rc * (r + gamma * nd * vs_next - v)


# -- the iteration -------------------------------------------------------------


@dataclass
class Observed:
    """What a training run shows of its first steps: the initial weights,
    every sampled action, the behaviour version each rollout was acted
    with, each step's loss and its terms (and the mean importance weight),
    the RMSProp accumulator after the first step and the weights after
    each step, as ``{path: tensor}`` trees, and the largest staleness of
    its call (``None`` for the synchronous loop). The reference adds its
    clipped first gradient and the widest gap of a followed action."""
    init: Dict[str, torch.Tensor]
    actions: List[torch.Tensor]
    versions: List[int]
    losses: List[Dict[str, float]]
    sq1: Dict[str, torch.Tensor]
    after: List[Dict[str, torch.Tensor]]
    staleness_max: Optional[int] = None
    grad1: Dict[str, torch.Tensor] = field(default_factory=dict)
    act_gap: float = 0.0


def _loss(p, net, job, obs, actions, rewards, dones, blogp, boot,
          fault: Optional[str]):
    T, E = actions.shape
    logits, values = forward(p, net, obs.reshape((T * E,) + obs.shape[2:]))
    logp_all = F.log_softmax(logits, dim=-1)
    a = actions.reshape(T * E)
    logp = logp_all.gather(1, a[:, None])[:, 0]
    gamma = job["gamma"]
    rho = torch.exp(logp.detach() - blogp.reshape(T * E))
    if fault == "rho_one":
        rho = torch.ones_like(rho)
    if job["backend"] == "pipelined":
        vs, adv = vtrace(rewards, dones, values.detach().reshape(T, E), boot,
                         rho.reshape(T, E), gamma, job["rho_bar"],
                         job["c_bar"])
        vs, adv = vs.reshape(T * E), adv.reshape(T * E)
        target = vs
    else:
        target = nstep_returns(rewards, dones, boot, gamma).reshape(T * E)
        adv = (target - values).detach()
    rows = torch.ones(T, E, dtype=torch.bool, device=obs.device)
    if fault == "half":  # the second half of the environments left out
        rows[:, E // 2:] = False
    rows = rows.reshape(T * E)
    entropy_each = -(logp_all.exp() * logp_all).sum(dim=-1)
    policy_loss = -(adv * logp)[rows].mean()
    entropy = entropy_each[rows].mean()
    value_loss = (target - values).square()[rows].mean()
    total = (policy_loss - job["entropy_beta"] * entropy
             + job["value_coef"] * value_loss)
    return total, {"policy_loss": policy_loss, "value_loss": value_loss,
                   "entropy": entropy, "rho_mean": rho.mean()}


def run(net: dict, job: dict, seed: int, device, dtype=torch.float64, *,
        steps: int = 3, follow: Optional[List[torch.Tensor]] = None,
        versions: Optional[List[int]] = None,
        states: Optional[List[Dict[str, torch.Tensor]]] = None,
        fault: Optional[str] = None) -> Observed:
    """The first ``steps`` iterations of the cell ``net`` x ``job`` from
    ``seed``, computed in ``dtype``; ``follow`` takes the program's
    actions in place of the reference's own draws, ``versions`` gives
    each rollout's behaviour version (at most its own index), ``states``
    the program's weights after each update, which the reference follows
    (``Observed.after`` then holds each of its updates from them)."""
    versions = list(range(steps) if versions is None else versions)[:steps]
    if len(versions) < steps or any(not 0 <= v <= i for i, v in
                                    enumerate(versions[:steps])):
        raise ValueError(f"behaviour versions {versions} for {steps} steps")
    if states is not None and len(states) < steps:
        raise ValueError(f"{len(states)} program states for {steps} steps")
    device = torch.device(device)
    g_param, g_env, g_act = seed_generators(seed, 3, device)
    A, E, T = job["num_actions"], job["n_envs"], job["t_max"]
    p32 = init_params(net, A, g_param)
    init = {k: v.clone() for k, v in leaves(p32).items()}
    params = _tree_map(lambda t: t.to(dtype), p32)
    sq = _tree_map(torch.zeros_like, params)
    env = CatchPixels(E, lives=job["lives"], action_repeat=job["action_repeat"],
                      max_noops=job["max_noops"], stack=job["frame_stack"],
                      device=device, dtype=dtype)
    state = env.reset(g_env)
    obs = state["stack"]
    lr = job["lr_per_env"] * E
    opt = job["rmsprop"]
    actions_all, losses, gap = [], [], 0.0
    sq1 = grad1 = None
    history = [params]  # the parameters after 0, 1, ... updates
    if states is not None:
        history += [_rebuild(params, {k: v.to(device=device, dtype=dtype)
                                      for k, v in st.items()})
                    for st in states[:steps - 1]]
    after = []
    for step in range(steps):
        params = history[step]
        traj = {k: [] for k in ("obs", "action", "reward", "done", "blogp")}
        acting = history[0 if fault == "stale" else versions[step]]
        with torch.no_grad():
            for t in range(T):
                logits, _ = forward(acting, net, obs)
                u = torch.rand((E, A), generator=g_act, device=device)
                z = logits - torch.log(-torch.log(u.to(dtype)))
                if follow is None:
                    a = z.argmax(dim=-1)
                    if fault == "action" and step == 0 and t == 0:
                        a = a.clone()
                        a[0] = (a[0] + 1) % A
                else:
                    a = follow[len(actions_all)].to(device=device,
                                                    dtype=torch.int64)
                    picked = z.gather(1, a[:, None])[:, 0]
                    gap = max(gap, float((z.max(dim=-1).values - picked).max()))
                actions_all.append(a.clone())
                blogp = logits.gather(1, a[:, None])[:, 0] - torch.logsumexp(
                    logits, dim=-1)
                state, nxt, r, d = env.step(state, a, g_env)
                for k, v in zip(traj, (obs, a, r, d, blogp)):
                    traj[k].append(v)
                obs = nxt
            _, boot = forward(params, net, obs)  # under the learner's
        tr = {k: torch.stack(v) for k, v in traj.items()}
        flat = leaves(params)
        names = list(flat)
        vals = [v.detach().requires_grad_(True) for v in flat.values()]
        with torch.enable_grad():
            p = _rebuild(params, dict(zip(names, vals)))
            total, terms = _loss(p, net, job, tr["obs"], tr["action"],
                                 tr["reward"], tr["done"], tr["blogp"], boot,
                                 fault)
            grads = torch.autograd.grad(total, vals)
        losses.append({"loss": float(total.detach()),
                       **{k: float(v.detach()) for k, v in terms.items()}})
        with torch.no_grad():
            norm = torch.sqrt(sum(gr.square().sum() for gr in grads))
            scale = torch.clamp(opt["clip_norm"] / torch.clamp(norm, min=1e-9),
                                max=1.0)
            grads = [gr * scale for gr in grads]
            sq_flat = leaves(sq)
            new_sq, new_p = {}, {}
            for n, pv, gr in zip(names, flat.values(), grads):
                s = opt["decay"] * sq_flat[n] + (1.0 - opt["decay"]) * gr.square()
                new_sq[n] = s
                new_p[n] = pv - lr * gr / (s.sqrt() + opt["eps"])
            if fault == "frozen":
                new_p, new_sq = dict(flat), dict(sq_flat)
            params, sq = _rebuild(params, new_p), _rebuild(sq, new_sq)
        after.append(leaves(params))
        if states is None:
            history.append(params)
        if step == 0:
            sq1 = {k: v.clone() for k, v in leaves(sq).items()}
            grad1 = dict(zip(names, grads))
    return Observed(init=init, actions=actions_all,
                    versions=[0] * steps if fault == "stale" else versions,
                    losses=losses, sq1=sq1, after=after, grad1=grad1,
                    act_gap=gap)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _rebuild(tree, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """``tree`` with each leaf replaced by ``flat[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, flat, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return flat[prefix.rstrip("/")]

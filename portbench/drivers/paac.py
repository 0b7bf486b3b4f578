"""The driver of the PAAC training cells: the paper's setting as
``repro_torch.launch.paper_atari.build`` makes it, run by ``ParallelRL``
(``"backend": "sync"``) or ``PipelinedRL`` (``"pipelined"``).

Set-up builds the trainer from the seed and drives it through one call
of the window's own kind, ``run(per_call)``, watching its first steps:
the actions it hands the env, the behaviour version each rollout was
acted with (a pipelined actor acts up to ``queue_depth + 1`` updates
behind the learner), each update's loss and its terms, the RMSProp
accumulator after the first update, the weights before the first and
after each, and the call's largest staleness. The same trainer then
runs the window, ``run(per_call)`` after ``run(per_call)``. Once the
window has closed and the trainer is freed, ``check`` runs the plain
reference over those first steps, following the watched actions,
versions and weights, and returns the numbers of ``paac_compare``.
"""
from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from portbench import counts
from portbench.drivers import paac_reference as reference
from portbench.drivers.paac_compare import numbers

STEPS = 3  # the first steps the reference follows


@dataclass
class Session:
    rl: object
    observed: reference.Observed
    steps_per_iter: int
    per_call: int
    device: torch.device


@dataclass
class Measured:
    iterations: int
    seconds: float
    work: int  # env timesteps
    failed: int  # iterations of a call whose mean loss was not finite
    counters: Dict[str, float]


def net_of(cell) -> dict:
    return {k: cell.config[k] for k in ("obs_shape", "cnn_spec", "cnn_dense")}


def flops_per_iter(cell) -> int:
    t = cell.traffic
    return counts.iteration_flops(net_of(cell), cell.config["num_actions"],
                                  t["n_envs"], t["t_max"])


def set_tf32(on: bool) -> None:
    """Both TF32 switches, so that no library default decides."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def set_precision(cell) -> None:
    """The configuration's stated precision, for the whole run."""
    set_tf32(cell.config["allow_tf32"])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _build(cell, seed: int, device):
    from repro_torch.configs import PipelineConfig
    from repro_torch.launch.paper_atari import build

    t, c = cell.traffic, cell.config
    pipeline = None
    if t["backend"] == "pipelined":
        pipeline = PipelineConfig(queue_depth=t["queue_depth"],
                                  rho_bar=t["rho_bar"], c_bar=t["c_bar"],
                                  num_actors=t["num_actors"])
    elif t["backend"] != "sync":
        raise ValueError(f"unknown backend {t['backend']!r}")
    rl = build(c["arch"], t["n_envs"], seed, device, pipeline)
    cfg, hp = rl.agent.cfg, rl.agent.hp
    stated = {"obs_shape": tuple(c["obs_shape"]),
              "cnn_spec": tuple(map(tuple, c["cnn_spec"])),
              "cnn_dense": c["cnn_dense"], "num_actions": c["num_actions"],
              "param_dtype": c["param_dtype"],
              "compute_dtype": c["compute_dtype"], "t_max": t["t_max"],
              "gamma": t["gamma"], "entropy_beta": t["entropy_beta"],
              "value_coef": t["value_coef"],
              "lr": t["lr_per_env"] * t["n_envs"]}
    built = {"obs_shape": tuple(cfg.obs_shape), "cnn_spec": tuple(cfg.cnn_spec),
             "cnn_dense": cfg.cnn_dense, "num_actions": rl.env.num_actions,
             "param_dtype": cfg.param_dtype,
             "compute_dtype": cfg.compute_dtype, "t_max": hp.t_max,
             "gamma": hp.gamma, "entropy_beta": hp.entropy_beta,
             "value_coef": hp.value_coef, "lr": rl.lr_schedule(0)}
    off = {k: (built[k], v) for k, v in stated.items()
           if not (built[k] == v or (isinstance(v, float)
                                     and math.isclose(built[k], v)))}
    if off:
        raise ValueError(f"the program builds another cell than the files "
                         f"state (built, stated): {off}")
    return rl


def _leaves(tree) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in reference.leaves(tree).items()}


def setup(cell, seed: int, device, fault: Optional[str] = None) -> Session:
    """The trainer, driven from the seed through one ``run(per_call)``
    whose first ``STEPS`` updates are watched.

    ``fault`` breaks the run underneath, for the tests: ``"action"``
    alters the first action the env is handed, ``"frozen"`` puts each
    update's parameters and optimizer state back (and publishes them)."""
    rl = _build(cell, seed, device)
    t = cell.traffic
    k = t["per_call"]
    if k < STEPS:
        raise ValueError(f"per_call {k} < the {STEPS} checked steps")
    env, actions, stepped = rl.env, [], [0]

    def watched_step(state, a, generator):
        if fault == "action" and not stepped[0]:
            a = a.clone()
            a[0] = (a[0] + 1) % cell.config["num_actions"]
        if len(actions) < STEPS * t["t_max"]:
            actions.append(a.detach().clone())
        stepped[0] += 1
        return type(env).step(env, state, a, generator)

    # the update the call drives: ParallelRL's train step, or the
    # pipelined learner's step with its publish (the new parameters copied
    # into the buffer the actor takes up next)
    pipelined = t["backend"] == "pipelined"
    attr = "_update_step" if pipelined else "_train_step"
    update, watched = getattr(rl, attr), []
    init, after = _leaves(rl.params), []
    sq1 = None

    def watched_update(*args):
        nonlocal sq1
        out = update(*args)
        if fault == "frozen":
            if pipelined:
                with torch.no_grad():
                    for dst, src in zip(reference.leaves(out[2]).values(),
                                        reference.leaves(args[0]).values()):
                        dst.copy_(src)
            out = (args[0], args[1]) + tuple(out[2:])
        if len(watched) < STEPS:
            watched.append({key: v.detach().clone()
                            for key, v in out[-1].items()
                            if key in reference.LOSS_TERMS})
            after.append(_leaves(out[0]))
            if len(watched) == 1:
                sq1 = _leaves(out[1]["sq"])
        return out

    env.step = watched_step
    setattr(rl, attr, watched_update)
    try:
        rl.run(k)
    finally:
        del env.step
        setattr(rl, attr, update)
    if stepped[0] != k * t["t_max"] or len(watched) != STEPS:
        raise RuntimeError(f"watched {stepped[0]} env steps and "
                           f"{len(watched)} updates in a call of {k} "
                           f"iterations of t_max {t['t_max']}")
    if pipelined:
        if rl.learned_ids != [(0, s) for s in range(k)]:
            raise RuntimeError(f"the learner took rollouts {rl.learned_ids}"
                               f", not one actor's in order")
        staleness = [int(s) for s in rl.staleness]
        versions = [i - s for i, s in enumerate(staleness)]
        staleness_max = max(staleness)
    else:
        versions, staleness_max = list(range(k)), None
    sync(device)
    losses = [{key: float(v) for key, v in w.items()} for w in watched]
    observed = reference.Observed(
        init=init, actions=actions, versions=versions[:STEPS], losses=losses,
        sq1=sq1, after=after, staleness_max=staleness_max)
    return Session(rl, observed, t["n_envs"] * t["t_max"], k,
                   torch.device(device))


def _calls(session: Session, until):
    """``run(per_call)`` until ``until(iterations)`` is true; -> Measured."""
    rl, n = session.rl, session.per_call
    iters = failed = 0
    idle = 0.0
    sync(session.device)
    t0 = time.perf_counter()
    while True:
        res = rl.run(n)
        iters += n
        idle += res.learner_idle_s
        if not math.isfinite(res.mean_metrics["loss"]):
            failed += n
        if until(iters, time.perf_counter() - t0):
            break
    sync(session.device)
    dt = time.perf_counter() - t0
    return Measured(iters, dt, iters * session.steps_per_iter, failed,
                    {"learner_idle_s": idle})


def window(session: Session, seconds: float) -> Measured:
    """Whole calls until ``seconds`` have passed; the rate is taken over
    all of them and all their time."""
    return _calls(session, lambda it, dt: dt >= seconds)


def stretch(session: Session) -> Measured:
    """One call, for the profiler."""
    return _calls(session, lambda it, dt: True)


def release(session: Session) -> reference.Observed:
    """Free the trainer; keep what the check needs."""
    observed = session.observed
    close = getattr(session.rl, "close", None)
    if close is not None:
        close()
    session.rl = None
    gc.collect()
    if session.device.type == "cuda":
        torch.cuda.empty_cache()
    return observed


def check(cell, seed: int, device, observed: reference.Observed,
          extra: bool = False) -> Dict[str, float]:
    """The plain reference over the first steps in float64, following the
    watched actions, behaviour versions and weights, and the numbers
    comparing the two (with ``extra``, those not compared too)."""
    ref = reference.run(net_of(cell), cell.job, seed, device, torch.float64,
                        steps=STEPS, follow=observed.actions,
                        versions=observed.versions, states=observed.after)
    return numbers(observed, ref, cell.traffic["rmsprop"]["decay"], extra)


def stand_in(cell, seed: int, device, *, tf32: bool,
             fault: Optional[str] = None, versions=None,
             staleness_max: Optional[int] = None,
             extra: bool = False) -> Dict[str, float]:
    """The reference in the program's place, in float32 with TF32 as
    given (the control: on, where the configuration states it off) and
    ``fault`` planted, acting each rollout with ``versions`` (by default
    the synchronous schedule) and showing ``staleness_max`` (a pipelined
    cell's; ``"stale"`` shows the call's whole lag), checked as a program
    run is. The TF32 switches come back as they were."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    set_tf32(tf32)
    try:
        prog = reference.run(net_of(cell), cell.job, seed, device,
                             torch.float32, steps=STEPS, versions=versions,
                             fault=fault)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was
    if cell.traffic["backend"] == "pipelined":
        prog.staleness_max = (cell.traffic["per_call"] - 1 if fault == "stale"
                              else staleness_max)
    return check(cell, seed, device, prog, extra)  # float64: TF32 unused

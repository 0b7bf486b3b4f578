"""Device-resident circular replay memory (Gorila/DQN-style substrate), the
port of ``repro/core/agents/replay.py``.

The paper positions multiple parallel actors as an *on-line experience
memory* (§3); this module provides the classic *off-line* one so the
framework also hosts off-policy algorithms (its algorithm-agnosticism
claim). A fixed-capacity ring buffer: a dict of tensors with leading axis
``capacity`` on one device, plus the ring pointer ``ptr`` and the fill
``size``. Those two are Python ints, not tensors: every add moves them by
a batch width known on the host, so no add and no sample ever reads a
number back from the device.

Unlike the reference's functional update, ``replay_add`` writes into the
buffer's tensors in place (a copy of a buffer of gigabytes per add would
cost more than the step it serves) and advances ``ptr`` and ``size`` in the
same dict, which it returns.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device

FIELDS = ("obs", "action", "reward", "next_obs", "done")


def replay_init(capacity: int, obs_shape, obs_dtype=torch.float32, *,
                device="cuda") -> Dict:
    dev = resolve_device(device)
    obs = (capacity,) + tuple(obs_shape)
    return {
        "obs": torch.zeros(obs, dtype=obs_dtype, device=dev),
        "action": torch.zeros((capacity,), dtype=torch.int32, device=dev),
        "reward": torch.zeros((capacity,), dtype=torch.float32, device=dev),
        "next_obs": torch.zeros(obs, dtype=obs_dtype, device=dev),
        "done": torch.zeros((capacity,), dtype=torch.bool, device=dev),
        "ptr": 0,
        "size": 0,
    }


def replay_nbytes(buf: Dict) -> int:
    """Device bytes the buffer's tensors hold."""
    return sum(buf[k].numel() * buf[k].element_size() for k in FIELDS)


def replay_add(buf: Dict, obs, action, reward, next_obs, done) -> Dict:
    """Add a batch of transitions (E, ...) at the ring pointer, in place.

    Requires ``E <= capacity``: with a wider batch the ring would wrap onto
    rows of the same batch, and which of two writes to one row lands is no
    more defined for ``index_copy_`` than for XLA's scatter. The check is
    on shapes, so the misuse is refused before anything is written.
    """
    E = action.shape[0]
    cap = buf["action"].shape[0]
    if E > cap:
        raise ValueError(
            f"replay_add: batch of {E} transitions exceeds capacity {cap} — "
            "duplicate scatter indices have unspecified write order; grow "
            "the buffer or split the batch")
    ptr = buf["ptr"]
    head = min(E, cap - ptr)  # rows up to the end of the ring, then wrap
    for k, x in zip(FIELDS, (obs, action, reward, next_obs, done)):
        dst = buf[k]
        x = x.to(dst.dtype)
        dst[ptr:ptr + head].copy_(x[:head])
        if head < E:
            dst[:E - head].copy_(x[head:])
    buf["ptr"] = (ptr + E) % cap
    buf["size"] = min(buf["size"] + E, cap)
    return buf


def replay_sample(buf: Dict, generator: torch.Generator, batch_size: int,
                  idx: Optional[torch.Tensor] = None) -> Dict:
    """Uniformly sample ``batch_size`` stored transitions (with replacement),
    the row indices drawn from ``generator``. ``idx``, if given, replaces the
    draw: a test seam that replays another run's indices.

    An empty buffer has nothing to sample and raises, instead of returning
    zero-initialized garbage rows. ``size`` is a host int, so the check
    costs no device sync.
    """
    size = buf["size"]
    if size == 0:
        raise ValueError(
            "replay_sample on an empty buffer — it would return "
            "zero-initialized garbage transitions; add before sampling")
    dev = buf["action"].device
    if idx is None:
        idx = torch.randint(0, size, (batch_size,), generator=generator,
                            device=dev)
    else:
        idx = idx.to(device=dev, dtype=torch.int64)
    return {k: buf[k][idx] for k in FIELDS}

"""Categorical sampling from explicit per-stream generators.

A draw depends only on its generator: ``stream_generator(seed, t, device)``
seeds a fresh ``torch.Generator`` from a fixed mix of ``(seed, t)``, so the
t-th token of the request with stream root ``seed`` is drawn the same way
whatever else runs beside it — the port's counterpart of the reference's
``fold_in(PRNGKey(seed), t)``. Sampling is Gumbel-max:
``argmax(logits + g)`` with ``g = -log(-log(u))``, ``u`` uniform.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def stream_generator(seed: int, t: int, device) -> torch.Generator:
    """The generator of token ``t`` of stream ``seed`` (both < 2**32)."""
    seed, t = int(seed), int(t)
    if not (0 <= seed < 2**32 and 0 <= t < 2**32):
        raise ValueError(f"stream seed {seed} and index {t} must lie in "
                         "[0, 2**32)")
    g = torch.Generator(device=device)
    g.manual_seed((seed << 32) | t)
    return g


def seeded_generators(seed: int, n: int, device) -> Tuple[torch.Generator, ...]:
    """``n`` independent generators on ``device`` from one root seed (numpy's
    ``SeedSequence(seed).spawn(n)``): no stream reuses another's seed, so
    e.g. weights and data are never correlated."""
    gens = []
    for ss in np.random.SeedSequence(seed).spawn(n):
        g = torch.Generator(device=device)
        g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
        gens.append(g)
    return tuple(gens)


def generator_state(gen: torch.Generator) -> bytes:
    """A generator's state as plain bytes (what crosses to a spawned child
    or into a checkpoint snapshot)."""
    return bytes(gen.get_state().numpy())


def set_generator_state(gen: torch.Generator, state: bytes) -> None:
    """Put ``generator_state``'s bytes back into ``gen`` (any device)."""
    gen.set_state(torch.frombuffer(bytearray(state), dtype=torch.uint8))


def _gumbel_max(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (logits.float() - torch.log(-torch.log(u))).argmax(dim=-1)


def categorical(logits: torch.Tensor, generator: torch.Generator):
    """One draw per row of ``logits`` (..., A), all rows from ``generator``.
    Returns int64 token ids of shape (...)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return _gumbel_max(logits, u)


def sample_streams(logits: torch.Tensor, seeds: Sequence[int],
                   tindex: Sequence[int]) -> torch.Tensor:
    """Row r of ``logits`` (R, A) draws token ``tindex[r]`` of stream
    ``seeds[r]``. Returns (R,) int64 token ids."""
    R, A = logits.shape
    if len(seeds) != R or len(tindex) != R:
        raise ValueError(f"{len(seeds)} seeds and {len(tindex)} indices for "
                         f"{R} rows")
    u = torch.stack([
        torch.rand(A, generator=stream_generator(s, t, logits.device),
                   device=logits.device)
        for s, t in zip(seeds, tindex)])
    return _gumbel_max(logits, u)

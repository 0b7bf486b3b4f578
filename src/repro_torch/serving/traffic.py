"""Open-loop traffic generation for the serving plane.

Open-loop means arrivals follow a fixed schedule (Poisson at a target
rate, or a burst) regardless of how fast the service drains them — the
standard way to expose queueing delay, as opposed to closed-loop clients
that wait for each response. The whole schedule (arrival times, prompt
lengths, generation lengths, per-request seeds) is drawn up front from
one ``numpy`` generator, so a given ``(seed, n)`` pair names a
reproducible workload for benches and the bitwise pin.

Prompt lengths are drawn from a small alphabet (default two lengths)
because the engine compiles one exact-length prefill per distinct prompt
length — see ``engine.py``.
"""
from __future__ import annotations

import threading
import time
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request

DEFAULT_PROMPT_LENS = (8, 16)


def make_requests(n: int, *, seed: int,
                  prompt_lens: Sequence[int] = DEFAULT_PROMPT_LENS,
                  gen_range: Tuple[int, int] = (4, 16),
                  vocab: int = 64) -> List[Request]:
    """Draw ``n`` requests (no arrival times — a burst workload)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        S = int(rng.choice(list(prompt_lens)))
        prompt = rng.integers(0, vocab, size=S, dtype=np.int32)
        gen = int(rng.integers(gen_range[0], gen_range[1] + 1))
        reqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=gen,
                            seed=int(rng.integers(0, 2**31 - 1))))
    return reqs


class OpenLoopTraffic(threading.Thread):
    """Feed a pre-drawn schedule into the admission queue on its clock.

    ``rate_hz > 0``: exponential inter-arrivals at that rate (Poisson
    process). ``rate_hz == 0``: a burst — every request enqueued
    immediately (capacity measurement; the queue's bounded depth is the
    only pacing). Calls ``queue.producer_done()`` on exit either way, so
    the scheduler sees ``CLOSED`` after the last request.
    """

    def __init__(self, queue, n: int, *, seed: int, rate_hz: float = 0.0,
                 prompt_lens: Sequence[int] = DEFAULT_PROMPT_LENS,
                 gen_range: Tuple[int, int] = (4, 16), vocab: int = 64):
        super().__init__(name="serve-traffic", daemon=True)
        self.queue = queue
        self.requests = make_requests(n, seed=seed, prompt_lens=prompt_lens,
                                      gen_range=gen_range, vocab=vocab)
        if rate_hz > 0:
            rng = np.random.default_rng(seed + 1)
            gaps = rng.exponential(1.0 / rate_hz, size=n)
            self.arrivals = np.cumsum(gaps)
        else:
            self.arrivals = np.zeros(n)

    def run(self) -> None:
        try:
            t0 = time.perf_counter()
            for req, at in zip(self.requests, self.arrivals):
                delay = (t0 + float(at)) - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                req.t_submit = time.perf_counter()
                self.queue.put(req)
        finally:
            self.queue.producer_done()

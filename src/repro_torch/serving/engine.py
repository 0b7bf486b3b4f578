"""Fixed-width decode engine shared by every scheduler mode.

The bitwise-equivalence guarantee (a request's tokens are the same
whatever co-resides in the batch) rests on two properties:

* **One shape.** The decode step always runs at the fixed batch width
  ``max_slots``: continuous with random join/leave traffic, lockstep, a
  solo single-request run all launch the same kernels on the same shapes.
* **Row independence.** Every op in the step is per row: the per-row
  position path of ``gqa_decode`` (index-scatter cache writes, per-row
  bound in the decode kernel) and per-request sampling — token ``t`` of
  the request with stream root ``seed`` is drawn from a generator seeded
  by ``(seed, t)`` alone (``utils/sampling.py``), never from a
  batch-shared one.

Stale cache rows need no zeroing between leases: admission copies a freshly
prefilled row over the slot, and attention never reads past the row's own
``pos``.

Prefill is exact-length and batch 1; the small cache is then copied into
the leased row by explicit indexing (``cache[:, slot] = small[:, 0]``).

The step reads ``pos``/``seeds``/``tindex`` from host numpy, as the
reference does, and never waits on device values: positions go up with a
non-blocking copy, sampled tokens stay on the device (fed back as the next
input and written to a device-side token log), and a request's tokens come
to the host once, at retire.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import (init_policy_cache, policy_decode,
                                policy_prefill)
from repro_torch.utils.sampling import sample_streams


def _place(big, small, slot: int) -> None:
    """Copy the one-row prefill cache ``small`` into row ``slot`` of
    ``big``; leaves are (L, rows, ...)."""
    if isinstance(big, dict):
        for k in big:
            _place(big[k], small[k], slot)
        return
    big[:, slot] = small[:, 0].to(big.dtype)


class DecodeEngine:
    """W-wide decode batch over the policy API of ``repro_torch.models``."""

    def __init__(self, cfg, params, *, max_slots: int, max_len: int,
                 device="cuda"):
        if cfg.family == "cnn":
            raise ValueError("serving needs a token-model family, not cnn")
        if cfg.is_encoder_decoder or cfg.modality == "vision":
            raise ValueError(
                "serving supports text token models only (no encoder-"
                "decoder / vision prefix plumbing on the admission path)")
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        W = max_slots
        self._pos = np.zeros(W, np.int32)
        self._tindex = np.zeros(W, np.int64)
        self._seeds = np.zeros(W, np.int64)
        self._tokens = torch.zeros((W, 1), dtype=torch.long, device=self.device)
        self._cache = init_policy_cache(cfg, W, max_len, device=self.device)
        # device-side token log: step g writes its (W,) sampled tokens to
        # row g % max_len; a request's tokens are harvested from its slot's
        # column in one slice at retire. A request spans at most
        # max_len - 1 consecutive steps, so its rows are not overwritten
        # before harvest.
        self._log = torch.zeros((max_len, W), dtype=torch.long,
                                device=self.device)
        self._glob = 0  # global decode-step counter (host int)
        self._g0 = np.zeros(W, np.int64)  # per-slot _glob at admission
        self._tok0: List[Optional[torch.Tensor]] = [None] * W

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting on the device."""
        t = torch.from_numpy(np.array(arr))  # a copy the caller may not mutate
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    # -- admission -----------------------------------------------------------
    def admit(self, slot: int, prompt: np.ndarray, seed: int) -> torch.Tensor:
        """Prefill ``prompt`` into cache row ``slot``. The first sampled
        token (stream index t=0) stays on the device until ``harvest``.
        Returns the prompt's last-position logits, (1, A) fp32, on the
        device."""
        prompt = np.asarray(prompt, np.int32)
        S = int(prompt.shape[0])
        if S + 1 > self.max_len:
            raise ValueError(
                f"prompt length {S} leaves no decode headroom in a "
                f"max_len={self.max_len} cache")
        tokens = self._upload(prompt.astype(np.int64))[None, :]
        logits, _values, small = policy_prefill(self.params, self.cfg, tokens,
                                                max_len=self.max_len)
        last = logits[:, -1]
        tok0 = sample_streams(last, [seed], [0])
        _place(self._cache, small, slot)
        self._tokens[slot] = tok0
        self._pos[slot] = S
        self._tindex[slot] = 1
        self._seeds[slot] = seed
        self._g0[slot] = self._glob
        self._tok0[slot] = tok0
        return last

    # -- decode --------------------------------------------------------------
    # hot-path
    def step(self) -> None:
        """One fixed-width decode step over every slot (leased or idle).
        Tokens land in the device-side log; nothing returns to the host."""
        row = self._glob % self.max_len
        pos = self._upload(self._pos)
        logits, _value, self._cache = policy_decode(
            self.params, self.cfg, self._cache, self._tokens, pos)
        toks = sample_streams(logits, self._seeds, self._tindex)
        self._log[row] = toks
        self._tokens = toks[:, None]
        self._pos += 1
        self._tindex += 1
        self._glob += 1

    def remaining(self, slot: int) -> int:
        """Decode headroom before the cache row overflows max_len."""
        return self.max_len - int(self._pos[slot])

    def harvest(self, slot: int, n: int) -> np.ndarray:
        """The first ``n`` tokens sampled for the request resident in
        ``slot`` — one column slice and one host transfer, at retire."""
        if n < 1:
            return np.zeros(0, np.int32)
        tok0 = self._tok0[slot].cpu().numpy().astype(np.int32)  # (1,)
        if n == 1:
            return tok0
        col = self._log[:, slot].cpu().numpy().astype(np.int32)
        rows = (self._g0[slot] + np.arange(n - 1)) % self.max_len
        return np.concatenate([tok0, col[rows]])

    def release(self, slot: int) -> None:
        """Reset host bookkeeping for a freed slot. The device rows are
        not zeroed: the next admit overwrites the cache row, and stale log
        rows are overwritten before any harvest can read them."""
        self._pos[slot] = 0
        self._tindex[slot] = 0
        self._seeds[slot] = 0
        self._g0[slot] = 0
        self._tok0[slot] = None

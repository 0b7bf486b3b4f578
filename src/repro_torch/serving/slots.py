"""Slot-managed KV/state-cache ownership for the decode batch.

``KVSlotCache`` is the serving twin of ``pipeline/ring.py``'s slot
discipline: the engine's big cache has ``capacity`` batch rows, and each
row is leased to exactly one request for its lifetime. The bookkeeping —
not the arrays — lives here; the ``DecodeEngine`` owns the device cache
and indexes it by the slot ids this class hands out.

Contract (mirrors the ring's ownership transfer, pinned by
``tests/test_torch_serving.py``):

* ``allocate(owner)`` leases the oldest free slot to ``owner``
  (FIFO reuse, like the ring's ticket order). Raises ``SlotsExhausted``
  when every slot is leased — the scheduler checks ``free_count`` and
  applies backpressure by leaving requests on the admission queue — and
  ``SlotCacheClosed`` after ``close()``.
* ``free(slot, owner)`` returns the lease. Freeing a slot you do not own
  (``wrong-owner``), or one already free (``double-free``), raises
  ``SlotError`` loudly — exactly the use-after-free class the ring turns
  into errors instead of silent corruption.
* ``evict(slot)`` is the cache manager's forced reclaim (request over ran
  its cache window, or an abort): it frees the slot *without* the owner
  token and returns the evicted owner so the scheduler can error the
  request. Evicting a free slot raises.
* ``owner_of(slot)`` / ``assert_owner(slot, owner)`` make use-after-free
  loud on the read side: both raise on a free slot, and ``assert_owner``
  raises when the slot was re-leased to someone else.
* ``close()`` stops new leases (``allocate`` raises); ``free``/``evict``
  still work so active requests drain.

A slot is freed only through ``free`` (request completion) or ``evict`` —
never implicitly.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, List, Optional


class SlotError(RuntimeError):
    """Lease-discipline violation: wrong owner, double free, or
    use-after-free on a slot id."""


class SlotsExhausted(SlotError):
    """allocate() with every slot leased — apply backpressure upstream."""


class SlotCacheClosed(RuntimeError):
    """allocate() on a closed cache."""


class KVSlotCache:
    """Ownership ledger for the decode batch's cache rows."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"slot capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._cond = threading.Condition()
        self._owner: List[Optional[Any]] = [None] * capacity
        self._free: Deque[int] = deque(range(capacity))
        self._closed = False
        self._evictions = 0
        self._leases = 0  # lifetime allocations (monotone, ticket idiom)

    def _check_slot(self, slot: int) -> None:
        if not (0 <= slot < self.capacity):
            raise SlotError(
                f"slot {slot} out of range [0, {self.capacity})")

    # hot-path
    def allocate(self, owner: Any) -> int:
        """Lease the oldest free slot to ``owner``; returns the slot id."""
        if owner is None:
            raise ValueError("owner must not be None (it is the lease token)")
        with self._cond:
            if self._closed:
                raise SlotCacheClosed("allocate() on a closed KVSlotCache")
            if not self._free:
                raise SlotsExhausted(
                    f"all {self.capacity} cache slots are leased — admission "
                    "must wait for a completion or evict")
            slot = self._free.popleft()
            self._owner[slot] = owner
            self._leases += 1
            return slot

    # hot-path
    def free(self, slot: int, owner: Any) -> None:
        """Return ``owner``'s lease on ``slot`` (completion path)."""
        self._check_slot(slot)
        with self._cond:
            cur = self._owner[slot]
            if cur is None:
                raise SlotError(
                    f"double-free: slot {slot} is already free")
            if cur != owner:
                raise SlotError(
                    f"wrong-owner free: slot {slot} is leased to {cur!r}, "
                    f"not {owner!r}")
            self._owner[slot] = None
            self._free.append(slot)
            self._cond.notify_all()

    def evict(self, slot: int) -> Any:
        """Forced reclaim by the cache manager; returns the evicted owner."""
        self._check_slot(slot)
        with self._cond:
            cur = self._owner[slot]
            if cur is None:
                raise SlotError(f"evict of free slot {slot}")
            self._owner[slot] = None
            self._free.append(slot)
            self._evictions += 1
            self._cond.notify_all()
            return cur

    def owner_of(self, slot: int) -> Any:
        """Current lease holder; raises on a free slot (use-after-free)."""
        self._check_slot(slot)
        with self._cond:
            cur = self._owner[slot]
            if cur is None:
                raise SlotError(
                    f"use-after-free: slot {slot} has no lease holder")
            return cur

    # hot-path
    def assert_owner(self, slot: int, owner: Any) -> None:
        """Loud use-after-free / stale-handle check on the read side."""
        cur = self.owner_of(slot)
        if cur != owner:
            raise SlotError(
                f"use-after-free: slot {slot} is leased to {cur!r}, "
                f"not {owner!r} — the slot was reused after this handle's "
                "lease ended")

    def close(self) -> None:
        """Stop new leases; active ones still drain via free/evict."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    @property
    def active_count(self) -> int:
        with self._cond:
            return self.capacity - len(self._free)

    @property
    def free_count(self) -> int:
        with self._cond:
            return len(self._free)

    @property
    def evictions(self) -> int:
        with self._cond:
            return self._evictions

    @property
    def leases_issued(self) -> int:
        """Lifetime allocations (monotone — the ring's ticket idiom)."""
        with self._cond:
            return self._leases

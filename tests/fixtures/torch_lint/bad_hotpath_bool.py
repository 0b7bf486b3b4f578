"""Fixture: hot-path-sync violation — ``bool()`` on a tensor on a hot path."""
import torch


# hot-path
def put(ring, item, stream, done):
    any_done = bool(item.done.any())  # host sync
    ring.append(item)

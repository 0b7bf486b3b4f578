"""Fixture: hot-path-sync violation — ``int()`` on a tensor on a hot path."""
import torch


# hot-path
def put(ring, item, stream, done):
    n = int(item.done.sum())  # host sync
    ring.append(item)

"""Fixture: hot-path-sync violation — ``.item()`` on a hot path."""
import torch


# hot-path
def put(ring, item, stream, done):
    n = item.reward.sum().item()  # host sync
    ring.append(item)

"""Fixture: hot-path-sync violation — ``float()`` on a tensor on a hot path."""
import torch


# hot-path
def put(ring, item, stream, done):
    total = float(item.reward.sum())  # host sync
    ring.append(item)

"""Fixture: hot-path-sync violation — ``.numpy()`` on a hot path."""
import torch


# hot-path
def put(ring, item, stream, done):
    host = item.reward.numpy()  # host sync
    ring.append(item)

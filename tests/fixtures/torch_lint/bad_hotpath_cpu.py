"""Fixture: hot-path-sync violation — ``.cpu()`` on a hot path."""
import torch


# hot-path
def put(ring, item, stream, done):
    host = item.reward.cpu()  # host sync
    ring.append(item)

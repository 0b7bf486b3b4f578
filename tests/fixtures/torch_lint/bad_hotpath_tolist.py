"""Fixture: hot-path-sync violation — ``.tolist()`` on a hot path."""
import torch


# hot-path
def put(ring, item, stream, done):
    rows = item.action.tolist()  # host sync
    ring.append(item)

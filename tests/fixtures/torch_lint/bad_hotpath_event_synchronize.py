"""Fixture: hot-path-sync violation — an event's .synchronize() on a hot path."""
import torch


# hot-path
def put(ring, item, stream, done):
    done.synchronize()  # host sync
    ring.append(item)

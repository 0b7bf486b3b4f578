"""Fixture: hot-path-sync violation — a stream's .synchronize() on a hot path."""
import torch


# hot-path
def put(ring, item, stream, done):
    stream.synchronize()  # host sync
    ring.append(item)

"""Fixture: hot-path-sync violation — ``torch.cuda.synchronize()`` on a hot path."""
import torch


# hot-path
def put(ring, item, stream, done):
    torch.cuda.synchronize()  # host sync
    ring.append(item)

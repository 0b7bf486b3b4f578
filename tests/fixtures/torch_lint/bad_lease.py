"""Fixture: lease-pairing violation — a ping-pong param lease taken
without a finally release."""


def leaky_collect(slot, collect, key):
    params, version, ready = slot.acquire(holder="leaky")
    traj = collect(params, key)      # raises here => lease never returned
    slot.release(version, holder="leaky")
    return traj

"""Fixture: lease-pairing violation, serving-plane vocabulary — a cache
slot allocated and never freed."""


def leaky_admit(slots, engine, req):
    slot = slots.allocate(req.rid)
    engine.admit(slot, req.prompt, req.seed)  # raises => slot leaks
    return slot

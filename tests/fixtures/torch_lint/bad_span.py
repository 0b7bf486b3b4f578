"""Fixture: span-pairing violation — begin() escapes via an early return."""


def leaky_get(em, ring):
    em.begin(1)
    payload = ring.get()
    if payload is None:
        return None                # open span leaks past this return
    em.end()
    return payload

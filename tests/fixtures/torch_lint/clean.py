"""Fixture: the negative — every rule's idiom done right, torch-flavoured."""
import torch


def good_collect(slot, collect, key):
    params, version, ready = slot.acquire(holder="good")
    try:
        return collect(params, key)
    finally:
        slot.release(version, holder="good")


def good_get(em, ring):
    em.begin(1)
    try:
        payload = ring.get()
    finally:
        em.end()
    return payload


def good_learner_iter(update_step, params, opt_state, traj, dst):
    params, opt_state, published = update_step(params, opt_state, traj, dst)
    return params, opt_state, published


# hot-path
def put(ring, item, stream):
    with torch.cuda.stream(stream):  # no host syncs on the hot path
        ring.append(item.reward.to("cuda", non_blocking=True))
    n = int(4)  # a constant: no sync
    return n

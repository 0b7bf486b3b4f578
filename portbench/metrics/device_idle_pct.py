"""The device's idle share of an iteration: 100 x (1 - the union of the
kernels' and copies' intervals an iteration in the profiled call / the
host time of an iteration in the untraced window). The profiler's own
host work about doubles the traced call's wall time, so the untraced
window gives the iteration's length."""


def read(ctx):
    t, w = ctx.trace, ctx.window
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.iterations) / (w.seconds / w.iterations))

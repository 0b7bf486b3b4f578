"""Device activities (kernels, copies, sets) of the profiled call, an
iteration: what the host dispatches."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    return len(t.device) / t.iterations

"""Device ms an iteration of the elementwise and reduction kernels (the
env and its frame stack, sampling, the losses, the optimizer), from the
profiled call."""
from portbench.profiling import ELEMENTWISE


def read(ctx):
    t = ctx.trace
    if t is None or not t.class_count(ELEMENTWISE):
        return None
    return 1e3 * t.class_seconds(ELEMENTWISE) / t.iterations

"""Device ms an iteration of the convolution and GEMM kernels (the CNN and
its heads, forward and backward), from the profiled call."""
from portbench.profiling import CONV, GEMM


def read(ctx):
    t = ctx.trace
    if t is None or not t.class_count(CONV, GEMM):
        return None
    return 1e3 * t.class_seconds(CONV, GEMM) / t.iterations

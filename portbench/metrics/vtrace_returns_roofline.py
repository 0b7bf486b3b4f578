"""K2's share of its roofline: the least time its bytes take at the HBM's
rate (each input read once, both outputs written once) over its mean
profiled time a launch, in %."""
from portbench import counts
from portbench.profiling import K2


def read(ctx):
    t = ctx.trace
    n = 0 if t is None else t.class_count(K2)
    if not n:
        return None
    least = counts.vtrace_bytes(ctx.cell.traffic["t_max"],
                                ctx.cell.traffic["n_envs"]) / counts.HBM_BYTES_PER_S
    return 100.0 * least / (t.class_seconds(K2) / n)

"""The learner's wait on an empty trajectory ring (``RunResult.
learner_idle_s``, summed over the window's calls), as a share of the
window."""


def read(ctx):
    w = ctx.window
    idle = w.counters.get("learner_idle_s")
    return None if idle is None else 100.0 * idle / w.seconds

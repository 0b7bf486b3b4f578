"""The whole step's share of the card's peak in the configuration's stated
precision: the model FLOPs of an iteration (``counts.iteration_flops``)
times the window's iterations, over the window's seconds and the peak."""


def read(ctx):
    if ctx.device.type != "cuda":  # a CPU run has no share of the card
        return None
    w = ctx.window
    return 100.0 * ctx.flops_per_iter * w.iterations / w.seconds / ctx.peak_flops

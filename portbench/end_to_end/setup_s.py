"""Set-up: from the start of the process to the start of the window
(loading, building or loading the kernels, the first steps), host clock."""


def read(ctx):
    return ctx.setup_s

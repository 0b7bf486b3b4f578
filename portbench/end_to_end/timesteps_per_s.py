"""Environment timesteps completed over the whole window, over all its
time on the host's clock, ended by a device synchronize."""


def read(ctx):
    return ctx.window.work / ctx.window.seconds

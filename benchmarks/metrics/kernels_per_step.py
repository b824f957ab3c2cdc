"""Device kernels of every kind in the traced window, per traced step."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.steps:
        return None
    return ctx.trace.n_kernels / ctx.trace.steps

"""The share of the traced window in which no operation runs on the card:
1 - (the union of device operation intervals / the window), in percent.
The run() cells' copy, which moves psteps_per_s.run."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

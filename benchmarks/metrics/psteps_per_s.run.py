"""Particle-steps a second: the particles alive at each step, summed over
every step completed in the measured window, over the window's wall from
its start to the sync after its last step (re-buckets, retunes and host
syncs in).
The run() cells' own metric: their host-paced rate spreads far wider
than the scan's, so it has a bound of its own."""


def read(ctx):
    return ctx.psteps / ctx.wall if ctx.wall > 0 else None

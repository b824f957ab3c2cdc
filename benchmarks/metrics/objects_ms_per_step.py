"""Device time of the operations launched inside the objects range
(TiledSimulation._absorb: the collision responses and the absorption), per
traced step."""


def read(ctx):
    return ctx.range_ms_per_step("bench.objects")

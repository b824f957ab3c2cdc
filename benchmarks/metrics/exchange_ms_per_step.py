"""Device time of the operations launched inside the re-bucket range
(TiledSimulation._rebucket_one), per traced step."""


def read(ctx):
    return ctx.range_ms_per_step("bench.rebucket")

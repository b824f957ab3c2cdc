"""Device time of the operations launched inside the field-solve range
(the simulation's solver), per traced step."""


def read(ctx):
    return ctx.range_ms_per_step("bench.solve")

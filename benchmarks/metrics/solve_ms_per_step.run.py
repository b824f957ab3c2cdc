"""Device time of the operations launched inside the field-solve range
(the simulation's solver), per traced step.
The run() cells' copy, which moves psteps_per_s.run."""


def read(ctx):
    return ctx.range_ms_per_step("bench.solve")

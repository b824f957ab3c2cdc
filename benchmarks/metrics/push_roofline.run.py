"""The push-and-deposit work's least time (work/push.py at the card's
peaks) over the device time per traced step outside the re-bucket, solve
and objects ranges, in percent.  Nothing where the card is not in the
table of peaks or nothing was traced.
The run() cells' copy, which moves psteps_per_s.run."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.trace.steps:
        return None
    push = ctx.work("push")
    outside = (ctx.trace.device_s
               - sum(ctx.trace.range_s.get(n, 0.0) for n in
                     ("bench.rebucket", "bench.solve", "bench.objects")))
    per_step = outside / ctx.trace.steps
    if per_step <= 0:
        return None
    return 100.0 * push.bound_s(ctx.ts, ctx.n_species, ctx.e_bytes,
                                ctx.peaks) / per_step

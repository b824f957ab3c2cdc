"""The median of run()'s own per-step host times (step_seconds) over the
measured window: a step of the CLI loop, each ending in the program's sync."""
import numpy as np


def read(ctx):
    if ctx.step_seconds is None or not len(ctx.step_seconds):
        return None
    return float(np.percentile(ctx.step_seconds, 50)) * 1e3

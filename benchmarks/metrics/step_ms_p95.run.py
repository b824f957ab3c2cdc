"""The 95th percentile of run()'s own per-step host times (step_seconds)
over the measured window; its tail is the electron re-bucket step."""
import numpy as np


def read(ctx):
    if ctx.step_seconds is None or len(ctx.step_seconds) < 200:
        return None
    return float(np.percentile(ctx.step_seconds, 95)) * 1e3

"""Slots a traced scan step found past its working margin: the program's
counter ``pinc.past_margin`` (K5's count, kept by the mega scan body) in
the tracer's report over the traced span (``ctx.program``), over the
traced steps.  Nothing where the run kept no report or ran no mega
window."""


def read(ctx):
    rep = getattr(ctx, "program", None)
    trace = getattr(ctx, "trace", None)
    if not rep or "pinc.past_margin" not in rep["counts"] \
            or trace is None or not trace.steps:
        return None
    return rep["counts"]["pinc.past_margin"] / trace.steps

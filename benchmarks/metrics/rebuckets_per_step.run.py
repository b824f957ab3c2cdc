"""Species re-bucketed a traced run() step, on the schedule and early at
a margin hit: the program's counter ``pinc.rebuckets`` in the tracer's
report (``ctx.program``), over its ``pinc.step`` calls.  Nothing where
the run kept no report or ran no run() step."""


def read(ctx):
    rep = getattr(ctx, "program", None)
    step = None if not rep else rep["spans"].get("pinc.step")
    if not step or not step["calls"]:
        return None
    return rep["counts"].get("pinc.rebuckets", 0) / step["calls"]

"""Host ms a traced run() step spent in TiledSimulation.retune (its
sample's copy to the host and the percentiles): the program's span
``pinc.retune`` in the tracer's report over the traced span
(``ctx.program``), over its ``pinc.step`` calls.  Nothing where the run
kept no report or ran no run() step."""


def read(ctx):
    rep = getattr(ctx, "program", None)
    step = None if not rep else rep["spans"].get("pinc.step")
    if not step or not step["calls"]:
        return None
    row = rep["spans"].get("pinc.retune")
    return 0.0 if row is None else row["seconds"] / step["calls"] * 1e3

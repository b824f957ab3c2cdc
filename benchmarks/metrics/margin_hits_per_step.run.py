"""run() steps of the traced span whose count of slots at the tile margin
was nonzero (the early re-bucket and the retune that follow it): the
program's counter ``pinc.margin_hits`` in the tracer's report
(``ctx.program``), over its ``pinc.step`` calls.  Nothing where the run
kept no report or ran no run() step."""


def read(ctx):
    rep = getattr(ctx, "program", None)
    step = None if not rep else rep["spans"].get("pinc.step")
    if not step or not step["calls"]:
        return None
    return rep["counts"].get("pinc.margin_hits", 0) / step["calls"]

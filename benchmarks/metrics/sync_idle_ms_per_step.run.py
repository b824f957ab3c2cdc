"""Device-idle ms a traced run() step spent inside the program's host
syncs: the idle time of the traced window inside the spans
``pinc.sync.<site>`` (program_pass.program_pass's ``sync_s``, summed over
the sites, from ``ctx.program_pass``), over the ``pinc.step`` calls of
the tracer's report (``ctx.program``).  Nothing where the run kept no
report or ran no run() step."""


def read(ctx):
    rep = getattr(ctx, "program", None)
    passed = getattr(ctx, "program_pass", None)
    step = None if not rep else rep["spans"].get("pinc.step")
    if not step or not step["calls"] or passed is None:
        return None
    return sum(passed["sync_s"].values()) / step["calls"] * 1e3

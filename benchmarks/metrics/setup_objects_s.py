"""Host seconds of set-up in the objects' capacitance matrices
(ObjectSystem.build): the program's span ``pinc.setup.objects`` in the
tracer's report over set-up (``ctx.program_setup``).  Nothing where the
run kept no report or the span never opened."""


def read(ctx):
    rep = getattr(ctx, "program_setup", None)
    row = None if not rep else rep["spans"].get("pinc.setup.objects")
    return None if row is None else row["seconds"]

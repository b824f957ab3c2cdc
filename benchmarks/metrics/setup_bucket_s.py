"""Host seconds of set-up in the initial bucketing of the particles
(TiledSimulation._bucket_all, _bucket_all_generate): the program's span
``pinc.setup.bucket`` in the tracer's report over set-up
(``ctx.program_setup``).  Nothing where the run kept no report or the span
never opened."""


def read(ctx):
    rep = getattr(ctx, "program_setup", None)
    row = None if not rep else rep["spans"].get("pinc.setup.bucket")
    return None if row is None else row["seconds"]

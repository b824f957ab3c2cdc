"""Host seconds of set-up in the kernel library's build, or its load where it
was built before (ops/_cuda_build.load): the program's span
``pinc.setup.build`` in the tracer's report over set-up
(``ctx.program_setup``).  Nothing where the run kept no report or the span
never opened."""


def read(ctx):
    rep = getattr(ctx, "program_setup", None)
    row = None if not rep else rep["spans"].get("pinc.setup.build")
    return None if row is None else row["seconds"]

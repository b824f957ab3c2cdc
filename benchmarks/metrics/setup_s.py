"""Set-up: from process start to the first measured step (the particles,
the layout, the object's capacitance, the kernel build or load, the
entry's warm-up), less the reference's fingerprints of the start."""


def read(ctx):
    return ctx.setup_s

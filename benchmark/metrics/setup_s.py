"""Seconds from the process's start to the window's opening: imports, the
device, the kernels built or loaded, weights and inputs, the first steps
and the warm-up."""


def read(ctx):
    return ctx.setup_s

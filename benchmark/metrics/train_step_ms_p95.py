"""The 95th percentile of every step's (iteration's) time in the window,
each between CUDA events recorded on the stream at step boundaries."""

from benchmark.harness.readers import percentile


def read(ctx):
    return percentile(ctx.step_ms, 95)

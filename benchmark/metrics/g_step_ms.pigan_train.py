"""Mean device-stream ms of the G step per iteration, between CUDA events
recorded before the G step and at the iteration's end (untraced
iterations)."""

from benchmark.harness.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "g_step")

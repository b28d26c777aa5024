"""Mean device-stream ms of the D step per iteration, between CUDA events
recorded before the D step and before the G step (untraced iterations)."""

from benchmark.harness.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "d_step")

"""Device ms per iteration of R1's gradient penalty in the D step
(``gan.r1``: its first backward, with the graph kept), between the
program's CUDA events in the device-only sub-window."""

from benchmark.harness.spans import span_ms


def read(ctx):
    return span_ms(ctx, "gan.d_step", ["gan.r1"], "device_ms")

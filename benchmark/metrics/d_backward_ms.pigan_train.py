"""Device ms per iteration of D's backward in the D step
(``gan.d_backward``: the loss and its gradients, R1's double backward
among them), between the program's CUDA events in the device-only
sub-window."""

from benchmark.harness.spans import span_ms


def read(ctx):
    return span_ms(ctx, "gan.d_step", ["gan.d_backward"], "device_ms")

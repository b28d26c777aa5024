"""Device ms per NeRF train step of the render library's own stages in the
forward (``render.samples`` + ``render.composite`` + ``render.resample``:
sampling, compositing, the fine samples and their sort; the MLP calls
left out), between the program's CUDA events in the device-only
sub-window."""

from benchmark.harness.spans import RENDER_STAGES, span_ms


def read(ctx):
    return span_ms(ctx, "nerf.step", RENDER_STAGES, "device_ms")

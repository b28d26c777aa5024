"""Device ms per view of the render library's own stages
(``render.samples`` + ``render.composite`` + ``render.resample`` under
``render.image``; the MLP calls left out), between the program's CUDA
events in the device-only sub-window."""

from benchmark.harness.spans import RENDER_STAGES, span_ms


def read(ctx):
    return span_ms(ctx, "render.image", RENDER_STAGES, "device_ms")

"""Host ms per NeRF train step of the port's Adam (``adam`` under
``nerf.step``), from the program's spans in the device-only sub-window."""

from benchmark.harness.spans import span_ms


def read(ctx):
    return span_ms(ctx, "nerf.step", ["adam"], "host_ms")

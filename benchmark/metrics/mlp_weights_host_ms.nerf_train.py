"""Host ms per NeRF train step of the MLP weights' preparation before each
fused MLP call (``nerf_mlp.weights``: ``pack_nerf_params``,
``kernel_weights`` and ``pad_points``), from the program's spans in the
device-only sub-window."""

from benchmark.harness.spans import span_ms


def read(ctx):
    return span_ms(ctx, "nerf.step", ["nerf_mlp.weights"], "host_ms")

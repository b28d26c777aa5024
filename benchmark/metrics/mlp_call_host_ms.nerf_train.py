"""Host ms per NeRF train step of the K1 and K2 wrappers
(``nerf_mlp.fwd_call`` + ``nerf_mlp.bwd_call``: the weights' checks, the
weight stacks and the ``ctypes`` entry that encodes the tensor maps), from
the program's spans in the device-only sub-window."""

from benchmark.harness.spans import span_ms


def read(ctx):
    return span_ms(ctx, "nerf.step",
                   ["nerf_mlp.fwd_call", "nerf_mlp.bwd_call"], "host_ms")

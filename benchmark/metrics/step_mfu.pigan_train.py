"""% of the card's peak: an iteration's model products (trunk, mapping
network, discriminator with R1's double backward, each at its stated
precision) over the traced window's time per iteration."""

from benchmark.drivers.pigan_train import stage_of
from benchmark.harness.readers import mfu
from benchmark.work import pigan


def read(ctx):
    return mfu(ctx, pigan.iteration_flops(ctx.config,
                                          stage_of(ctx.config, ctx.traffic)))

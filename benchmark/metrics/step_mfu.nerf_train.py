"""% of the card's peak: the train step's MLP products (forward, weight and
input gradients of both MLPs, at the train MLP's precision) over the traced
window's time per step."""

from benchmark.harness.readers import mfu
from benchmark.work import nerf


def read(ctx):
    return mfu(ctx, nerf.train_step_flops(ctx.config,
                                          ctx.traffic["batch_rays"]))

"""% of the card's peak: a view's MLP products (both passes, at the
render MLP's precision) over the traced window's time per view."""

from benchmark.drivers.nerf_train import image_geometry
from benchmark.harness.readers import mfu
from benchmark.work import nerf


def read(ctx):
    width, height, _ = image_geometry(ctx.config)
    return mfu(ctx, nerf.view_flops(ctx.config, width * height))

"""% of the roofline of a view's MLPs on the port's fused fp32 forward: the
view's least time (its products at the render MLP's precision) over the
device time of the kernels of KERNELS.  The work is counted once, whatever
implements it, so a forward of three tf32 products per product (3xTF32)
reads at most 33.3%.  Nothing to read where no such kernel ran."""

from benchmark.drivers.nerf_train import image_geometry
from benchmark.harness.readers import roofline
from benchmark.work import nerf

# the view's fused fp32 MLP forward (3xTF32 on the tensor cores)
KERNELS = ("nerf_fwd_tf32_kernel",)


def read(ctx):
    width, height, _ = image_geometry(ctx.config)
    return roofline(ctx, nerf.view_flops(ctx.config, width * height), 0.0,
                    KERNELS)

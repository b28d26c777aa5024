"""% of the roofline of the train step's two MLPs: their least time (the
larger of their products at the train MLP's peak and their own bytes at
the HBM rate) over the device time of the kernels of KERNELS."""

from benchmark.harness.readers import roofline
from benchmark.work import nerf

# the fused NeRF MLP's kernels: K1, K2's delta chain, the split-K dW pass
KERNELS = ("nerf_fwd_tc_kernel", "nerf_bwd_delta_tc_kernel",
           "dw_splitk_tc_kernel", "sum_splits_kernel")


def read(ctx):
    rays = ctx.traffic["batch_rays"]
    return roofline(ctx, nerf.train_step_flops(ctx.config, rays),
                    nerf.train_step_mlp_bytes(ctx.config, rays), KERNELS)

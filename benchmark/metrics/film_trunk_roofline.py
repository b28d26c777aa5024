"""% of the roofline of the FiLM-SIREN trunk in an iteration: its least
time (its forward and backward products, each at its stated precision, or
its own bytes at the HBM rate) over the device time of the kernels of
KERNELS."""

from benchmark.drivers.pigan_train import stage_of
from benchmark.harness.readers import roofline
from benchmark.work import pigan

# K8 (fp32 3xTF32 and bf16), K7's passes and its split-K dW pass
KERNELS = ("film_fwd_tf32_kernel", "film_fwd_tc_kernel", "film_fwd_kernel",
           "film_bwd_delta", "image_sums_kernel", "film_finish_kernel",
           "dw_splitk", "sum_splits_kernel")


def read(ctx):
    stage = stage_of(ctx.config, ctx.traffic)
    return roofline(ctx, pigan.trunk_flops(ctx.config, stage),
                    pigan.trunk_bytes(ctx.config, stage), KERNELS)

"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense,
without sparsity, at its 700 W limit).

A part's products are reckoned at the peak of the precision the
configuration states for it.  float32 is reckoned at the TF32 tensor-core
rate, the highest at which the card takes float32 inputs, so no route that
keeps float32 inputs can read above 100%."""

FLOP_PER_S = {
    "bf16": 989.4e12,
    "fp16": 989.4e12,
    "fp8": 1978.9e12,
    "tf32": 494.7e12,
    "fp32": 494.7e12,
}
FP32_SIMT_FLOP_PER_S = 66.9e12   # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: dict, bytes_moved: float = 0.0) -> float:
    """The least time of work that does ``flops`` ({precision: FLOPs}, run
    one after another) and moves ``bytes_moved`` through HBM."""
    compute = sum(f / FLOP_PER_S[p] for p, f in flops.items())
    return max(compute, bytes_moved / HBM_BYTES_PER_S)

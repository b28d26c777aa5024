"""msra_practice_project_tpu_torch — the PyTorch/CUDA port of
``msra_practice_project_tpu`` for NVIDIA Hopper (H100).

The module layout mirrors the JAX package, so each module's counterpart sits
at the same relative path.  Plain tensor code is PyTorch; each Pallas kernel
of the JAX package becomes a kernel hand-written for ``sm_90a`` under
``ops/kernels/``.  This package never imports JAX nor the JAX package.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without a
card they raise instead of quietly running on the CPU (``resolve_device``).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the CPU only when
    the caller asks for it.  Raises when CUDA is asked for (or defaulted to)
    and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def set_plain_precision() -> None:
    """Full fp32 for the plain (non-kernel) float32 paths: no TF32 in
    matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

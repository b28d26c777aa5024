"""Neural-net primitives (port of ``msra_practice_project_tpu/core/nn.py``):
Xavier-uniform dense init with the reference's activation gains, and the
positional encoding with its interleaved ``[sin_i(3), cos_i(3)]`` layout.

Weights follow ``torch.nn.Linear``: ``[out, in]``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# torch.nn.init.calculate_gain equivalents for Xavier init.
GAINS = {
    "linear": 1.0,
    "sigmoid": 1.0,
    "relu": math.sqrt(2.0),
    "tanh": 5.0 / 3.0,
    "leaky_relu": math.sqrt(2.0 / (1.0 + 0.2**2)),
    "sin": 1.0,
}


def xavier_uniform_(weight: torch.Tensor, gain: float = 1.0,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Xavier/Glorot uniform, in place, on an ``[out, in]`` weight."""
    out_dim, in_dim = weight.shape
    bound = gain * math.sqrt(6.0 / (in_dim + out_dim))
    with torch.no_grad():
        return weight.uniform_(-bound, bound, generator=generator)


def dense_init(in_dim: int, out_dim: int, activation: str = "linear",
               generator: torch.Generator | None = None,
               device=None) -> nn.Linear:
    """``nn.Linear`` with a Xavier-uniform weight (gain from the activation)
    and a zero bias."""
    layer = nn.Linear(in_dim, out_dim, device=device)
    xavier_uniform_(layer.weight, GAINS[activation], generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


def positional_encoding(x: torch.Tensor, length: int) -> torch.Tensor:
    """``[sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(2^{L-1} x)]`` along
    the last axis, interleaved per frequency as in the reference.  Output dim
    is ``x.shape[-1] * 2 * length``."""
    freqs = 2.0 ** torch.arange(length, dtype=x.dtype, device=x.device)
    xs = x[..., None, :] * freqs[:, None]            # [..., L, D]
    enc = torch.stack([torch.sin(xs), torch.cos(xs)], dim=-2)
    return enc.reshape(*x.shape[:-1], 2 * length * x.shape[-1])


def positional_encoding_dim(input_dim: int, length: int) -> int:
    return input_dim * 2 * length

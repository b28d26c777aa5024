"""Neural-net primitives (port of ``msra_practice_project_tpu/core/nn.py``):
Xavier-uniform dense init with the reference's activation gains, the
torch-default, SIREN and FiLM-SIREN inits, the trunk sine with its
derivative, the SIREN and FiLM-SIREN layers, and the positional encoding with
its interleaved ``[sin_i(3), cos_i(3)]`` layout.

Weights follow ``torch.nn.Linear``: ``[out, in]``.  Every init draws from an
explicit ``torch.Generator`` (weight first, then bias).

The trunk sine is the polynomial ``fast_sin`` unless ``MSRA_TPU_FAST_SIN=0``
(read at import, as the JAX package reads it), which makes it ``torch.sin``.
"""

from __future__ import annotations

import math
import os

import torch
from torch import nn
from torch.autograd.function import once_differentiable

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


def torch_linear_default(in_dim: int, out_dim: int,
                         generator: torch.Generator | None = None,
                         device=None) -> nn.Linear:
    """``torch.nn.Linear``'s default init drawn from ``generator``: weight and
    bias U(+-1/sqrt(in))."""
    bound = 1.0 / math.sqrt(in_dim)
    return _uniform_linear(in_dim, out_dim, bound, bound, generator, device)


def siren_init(in_dim: int, out_dim: int, scheme: str = "nerf",
               generator: torch.Generator | None = None,
               device=None) -> nn.Linear:
    """Init of a sine layer (JAX ``core/nn.py::siren_init``).

    scheme:
      'torch_default' -- weight and bias U(+-1/sqrt(in)), torch's Linear.
      'first'         -- weight U(+-1/in), torch-default bias
                         (siren/modules.py:79).
      'hidden'        -- weight U(+-sqrt(6/in)/30), torch-default bias
                         (siren/modules.py:83).
      'nerf'          -- weight U(+-sqrt(6/in)/30), zero bias
                         (nerf/nerf.py:114-117).
      'nerf_first'    -- weight U(+-1/30), zero bias (nerf/nerf.py:134).
    A zero bias draws nothing from ``generator``."""
    b_bound = 1.0 / math.sqrt(in_dim)
    if scheme == "torch_default":
        w_bound = 1.0 / math.sqrt(in_dim)
    elif scheme == "first":
        w_bound = 1.0 / in_dim
    elif scheme == "hidden":
        w_bound = math.sqrt(6.0 / in_dim) / 30.0
    elif scheme == "nerf":
        w_bound, b_bound = math.sqrt(6.0 / in_dim) / 30.0, 0.0
    elif scheme == "nerf_first":
        w_bound, b_bound = 1.0 / 30.0, 0.0
    else:
        raise ValueError(f"unknown siren init scheme '{scheme}'")
    if b_bound > 0:
        return _uniform_linear(in_dim, out_dim, w_bound, b_bound, generator,
                               device)
    layer = nn.Linear(in_dim, out_dim, device=device)
    with torch.no_grad():
        layer.weight.uniform_(-w_bound, w_bound, generator=generator)
        layer.bias.zero_()
    return layer


def film_siren_init(in_dim: int, out_dim: int, c: float = 6.0,
                    w0: float = 30.0, is_first_layer: bool = False,
                    generator: torch.Generator | None = None,
                    device=None) -> nn.Linear:
    """FiLM-SIREN layer init (ref: pi_GAN/modules.py:27-31): weight U(+-1/in)
    for the first layer, else U(+-sqrt(c/in)/w0); bias U(+-sqrt(1/in))."""
    w_bound = (1.0 / in_dim) if is_first_layer else math.sqrt(c / in_dim) / w0
    return _uniform_linear(in_dim, out_dim, w_bound, math.sqrt(1.0 / in_dim),
                           generator, device)


def _uniform_linear(in_dim, out_dim, w_bound, b_bound, generator, device):
    layer = nn.Linear(in_dim, out_dim, device=device)
    with torch.no_grad():
        layer.weight.uniform_(-w_bound, w_bound, generator=generator)
        layer.bias.uniform_(-b_bound, b_bound, generator=generator)
    return layer


# ---------------------------------------------------------------------------
# The trunk sine: by default a degree-7 odd minimax polynomial with exact
# fp32 range reduction (max abs error 1.8e-6 over [-30, 30]).  The FiLM
# kernels (ops/kernels/csrc/film_mlp.cu) compute the same steps with the
# same roundings, and have exact-sine variants for MSRA_TPU_FAST_SIN=0.
# Positional encodings keep the exact torch.sin either way.
# ---------------------------------------------------------------------------

_TWO_PI = 6.283185307179586
_SIN_POLY = (0.99999660, -0.16664824, 0.00830629, -0.00018363)

# MSRA_TPU_FAST_SIN=0 makes the trunk sine torch.sin (the JAX package's
# kill switch).  Read at call time by trunk_sin, trunk_sin_vjp and the FiLM
# kernels' wrappers, so tests may flip it.
USE_FAST_SIN = os.environ.get("MSRA_TPU_FAST_SIN", "1") != "0"


def _sin_reduce(v):
    """(r, flip): v - round(v / 2 pi) 2 pi reflected into [-pi/2, pi/2], and
    whether it was reflected.  torch.round rounds half to even, as jnp.round
    does."""
    q = torch.round(v * (1.0 / _TWO_PI))
    r = v - q * _TWO_PI
    hi, lo = r > 0.5 * math.pi, r < -0.5 * math.pi
    r = torch.where(hi, math.pi - r, r)
    r = torch.where(lo, -math.pi - r, r)
    return r, hi | lo


def fast_sin(v: torch.Tensor) -> torch.Tensor:
    """sin(v) as the range-reduced degree-7 odd minimax polynomial."""
    r, _ = _sin_reduce(v)
    r2 = r * r
    c1, c3, c5, c7 = _SIN_POLY
    return r * (c1 + r2 * (c3 + r2 * (c5 + r2 * c7)))


def trunk_sin(v: torch.Tensor, fast: bool | None = None) -> torch.Tensor:
    """The sine of the SIREN/FiLM activation trunks: ``fast_sin`` or, with
    ``fast`` False, ``torch.sin``; ``fast`` None reads ``USE_FAST_SIN``."""
    if fast is None:
        fast = USE_FAST_SIN
    return fast_sin(v) if fast else torch.sin(v)


def trunk_sin_vjp(v: torch.Tensor, fast: bool | None = None) -> torch.Tensor:
    """d trunk_sin(v) / dv, consistent with autograd of ``trunk_sin``: the
    polynomial's derivative, its sign flipped on the reflected branches, or
    ``torch.cos`` for the exact sine."""
    if fast is None:
        fast = USE_FAST_SIN
    if not fast:
        return torch.cos(v)
    r, flip = _sin_reduce(v)
    r2 = r * r
    c1, c3, c5, c7 = _SIN_POLY
    dp = c1 + r2 * (3 * c3 + r2 * (5 * c5 + r2 * (7 * c7)))
    return torch.where(flip, -dp, dp)


def siren_apply(layer: nn.Linear, x: torch.Tensor,
                w0: float = 30.0) -> torch.Tensor:
    """sin(w0 * (x W^T + b)) through the trunk sine."""
    return trunk_sin(w0 * layer(x))


class FilmSine(torch.autograd.Function):
    """``trunk_sin(w0 * (gamma * lin + beta))`` that saves only lin, gamma
    and beta for its backward, which recomputes the pre-activation and takes
    ``trunk_sin_vjp`` of it.  Autograd of the same expression keeps every
    step of the sine (r, r^2, the Horner partials, the reflection masks),
    where this keeps lin alone of the point-sized tensors.  The trunk sine is
    read once, at the forward, and the backward takes the same one.  Once
    differentiable: a second backward through it raises."""

    @staticmethod
    def forward(ctx, lin, gamma, beta, w0):
        ctx.w0, ctx.fast_sin = w0, USE_FAST_SIN
        ctx.save_for_backward(lin, gamma, beta)
        return trunk_sin(w0 * (gamma * lin + beta), ctx.fast_sin)

    @staticmethod
    @once_differentiable
    def backward(ctx, dh):
        lin, gamma, beta = ctx.saved_tensors
        dv = dh * trunk_sin_vjp(ctx.w0 * (gamma * lin + beta), ctx.fast_sin)
        dv.mul_(ctx.w0)
        need = ctx.needs_input_grad
        return (dv * gamma if need[0] else None,
                (dv * lin).sum_to_size(gamma.shape) if need[1] else None,
                dv.sum_to_size(beta.shape) if need[2] else None, None)


def film_siren_apply(layer: nn.Linear, x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, w0: float = 30.0) -> torch.Tensor:
    """sin(w0 * (gamma * (x W^T + b) + beta)); gamma/beta broadcast against
    the feature axis.  Under autograd the sine is ``FilmSine``, whose
    backward recomputes the pre-activation instead of keeping the sine's
    steps; without it, the same expression frees ``x W^T + b`` early."""
    if not torch.is_grad_enabled():
        return trunk_sin(w0 * (gamma * layer(x) + beta))
    return FilmSine.apply(layer(x), gamma, beta, w0)


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

"""Matmul and convolution operands rounded to a stated precision.

The plain reference runs every product in float32 with TF32 off
(``plain_float32``).  A control puts the reference in the program's place one
precision step lower than the configuration states: TF32 for a float32 part,
fp8 (e4m3, one scale per tensor, as fp8 GEMMs are fed) for a bfloat16 part.
``round_to`` gives the operand a product of that precision reads, so the same
reference code runs at any of them, on the CPU as on the card.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "tf32", "bf16", "fp8")
FP8_MAX = 448.0   # the largest finite float8_e4m3fn


def round_to(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` (float32) rounded to nearest-even in ``prec``, back in float32."""
    if prec == "fp32":
        return x
    if prec == "tf32":
        # keep 10 of the 23 mantissa bits, ties to even
        i = x.contiguous().view(torch.int32)
        lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
        i = torch.bitwise_and(i + 0xFFF + lsb, -0x2000)
        return i.view(torch.float32)
    if prec == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if prec == "fp8":
        amax = x.detach().abs().amax()
        scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    raise ValueError(f"unknown precision {prec!r}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


class _RoundedLinear(torch.autograd.Function):
    """y = x W^T + b with the forward's operands in ``fwd`` and the
    backward's (dy with W for dx, dy with x for dW) in ``bwd``."""

    @staticmethod
    def forward(ctx, x, w, b, fwd, bwd):
        ctx.save_for_backward(x, w)
        ctx.bwd = bwd
        y = round_to(x, fwd) @ round_to(w, fwd).t()
        return y if b is None else y + b

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy_r = round_to(dy.contiguous(), ctx.bwd)
        dx = dy_r @ round_to(w, ctx.bwd)
        dw = _rows(dy_r).t() @ _rows(round_to(x.contiguous(), ctx.bwd))
        db = _rows(dy).sum(0)
        return dx, dw, db, None, None


def linear(x, w, b=None, fwd: str = "fp32", bwd: str = "fp32"):
    """``F.linear`` in float32, or with rounded operands for a control."""
    if fwd == "fp32" and bwd == "fp32":
        return F.linear(x, w, b)
    return _RoundedLinear.apply(x, w, b, fwd, bwd)


def _straight_through(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` rounded in the forward, the identity for every derivative (so a
    double backward, as R1 takes, runs through it)."""
    if prec == "fp32":
        return x
    return x + (round_to(x.detach(), prec) - x.detach())


def conv2d(x, w, b, padding: int = 0, prec: str = "fp32"):
    """A convolution with its forward operands rounded to ``prec``; on the
    card ``tensor_cores(prec)`` also makes cuDNN's own passes TF32."""
    return F.conv2d(_straight_through(x, prec), _straight_through(w, prec), b,
                    padding=padding)


@contextlib.contextmanager
def tensor_cores(prec: str = "fp32"):
    """TF32 in cuBLAS and cuDNN on for a TF32 control, off otherwise; the
    previous settings come back on exit."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = prec == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def plain_float32():
    """The reference's own setting: every product in float32."""
    return tensor_cores("fp32")


def lower(prec: str) -> str:
    """The control's precision for a part stated in ``prec``."""
    return {"fp32": "tf32", "tf32": "bf16", "bf16": "fp8",
            "fp8": "fp8"}[prec]

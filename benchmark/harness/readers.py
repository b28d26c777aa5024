"""The arithmetic the metrics' readers share.  Each returns None where its
run has nothing to read (no trace, no kernel of the set), never 0."""

from __future__ import annotations

import statistics

from ..work.peaks import FLOP_PER_S, least_seconds
from .trace import is_port_kernel


def rate(ctx) -> float | None:
    """Items completed per second over the whole window."""
    return ctx.items / ctx.window_s if ctx.steps and ctx.window_s > 0 else None


def percentile(values, q: int) -> float | None:
    """The q-th percentile (inclusive quantiles) of every value."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def untraced(ctx, values: list) -> list:
    """The values of the steps after the traced sub-windows."""
    return values[ctx.traced_steps:]


def mean_ms(ctx, part: str) -> float | None:
    values = untraced(ctx, ctx.parts_ms.get(part, []))
    return statistics.fmean(values) if values else None


def mfu(ctx, flops_per_step: dict) -> float | None:
    """% of the peak: the step's products, each at its precision's peak,
    over the traced window's time per step."""
    t = ctx.trace
    if t is None or not t.steps:
        return None
    need = sum(f / FLOP_PER_S[p] for p, f in flops_per_step.items())
    return 100.0 * need / (t.window_s / t.steps)


def roofline(ctx, flops_per_step: dict, bytes_per_step: float,
             patterns) -> float | None:
    """% of the roofline: the layer's least time over the device time of
    the kernels whose names hold one of ``patterns``."""
    t = ctx.trace
    if t is None or not t.steps:
        return None
    spent = t.op_seconds(lambda n: any(p in n for p in patterns)) / t.steps
    if spent <= 0:
        return None
    return 100.0 * least_seconds(flops_per_step, bytes_per_step) / spent


def plain_ms(ctx) -> float | None:
    """ms per step of the device operations that are not the port's
    kernels."""
    t = ctx.trace
    if t is None or not t.steps:
        return None
    return 1e3 * t.op_seconds(lambda n: not is_port_kernel(n)) / t.steps


def idle_share(ctx) -> float | None:
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

"""Median host ms of one call of the train step, on steps that each start
on an idle device (a sub-window of the traced run): what the host alone
costs a step."""

import statistics


def read(ctx):
    return statistics.median(ctx.enqueue_ms) if ctx.enqueue_ms else None

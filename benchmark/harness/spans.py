"""The program's own spans (``core/diagnostics.span`` of the port) as the
per-layer metrics read them.

A span records only while a ``torch.profiler`` records, and set-up runs
with none, so the first ``ctx.trace.steps`` occurrences of a root span are
the steps of the device-only sub-window, which comes first; the
host-and-device sub-window's roots come after them and are not read.  A
program without spans (one older than them) reads nothing."""

from __future__ import annotations

# the render library's own stages, its MLP calls left out
RENDER_STAGES = ("render.samples", "render.composite", "render.resample")


def span_ms(ctx, root: str, names, kind: str) -> float | None:
    """ms per occurrence of ``root`` of the spans ``names`` under it,
    summed: ``kind`` is ``"host_ms"`` (the host's clock from entry to exit)
    or ``"device_ms"`` (the stream's, between CUDA events).  None without a
    trace, without the program's spans, or with none of ``names``."""
    t = ctx.trace
    if t is None or not t.steps:
        return None
    try:
        from msra_practice_project_tpu_torch.core import diagnostics
    except ImportError:
        return None
    span_steps = getattr(diagnostics, "span_steps", None)
    per = span_steps(root, t.steps) if span_steps is not None else None
    if per is None:
        return None
    found = [per[n][kind] for n in names if n in per]
    return sum(found) if found else None

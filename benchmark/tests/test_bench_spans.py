"""The readers of the program's spans (``harness/spans.py`` and the
metrics that use it), on the CPU, where a span's device time is its host
time."""

from __future__ import annotations

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.cell import Context
from benchmark.harness.registry import Registry
from benchmark.harness.trace import Trace
from msra_practice_project_tpu_torch.core import diagnostics as D

REG = Registry()
RENDER = ("render.samples", "render.composite", "render.resample")
# metric: (root, the spans it sums, under which parent in the tree below)
METRICS = {
    "mlp_weights_host_ms.nerf_train": ("nerf.step", ("nerf_mlp.weights",)),
    "mlp_call_host_ms.nerf_train": ("nerf.step", ("nerf_mlp.fwd_call",
                                                  "nerf_mlp.bwd_call")),
    "adam_host_ms.nerf_train": ("nerf.step", ("adam",)),
    "render_ms.nerf_train": ("nerf.step", RENDER),
    "render_ms.nerf_render": ("render.image", RENDER),
    "r1_ms.pigan_train": ("gan.d_step", ("gan.r1",)),
    "d_backward_ms.pigan_train": ("gan.d_step", ("gan.d_backward",)),
}
# each root's tree: (name, ms of its own, children); every ms is scaled by
# the root's occurrence (1, 2, 3, ...)
TREES = {
    "nerf.step": ("nerf.step", 0.5, [
        ("nerf.render", 0.1, [
            ("render.samples", 0.2, []),
            ("render.mlp", 0.0, [("nerf_mlp.weights", 0.3, []),
                                 ("nerf_mlp.fwd_call", 0.4, [])]),
            ("render.composite", 0.5, []),
            ("render.resample", 0.6, []),
            ("render.mlp", 0.0, [("nerf_mlp.weights", 0.3, []),
                                 ("nerf_mlp.fwd_call", 0.4, [])]),
            ("render.composite", 0.5, [])]),
        ("nerf.loss", 0.1, []),
        ("nerf.backward", 0.1, [("nerf_mlp.bwd_call", 0.7, []),
                                ("nerf_mlp.bwd_call", 0.7, [])]),
        ("adam", 0.8, [])]),
    "render.image": ("render.image", 1.0, [
        ("render.samples", 2.0, []), ("render.mlp", 9.0, []),
        ("render.composite", 3.0, []), ("render.resample", 4.0, []),
        ("render.mlp", 9.0, []), ("render.composite", 3.0, [])]),
    "gan.d_step": ("gan.d_step", 0.5, [
        ("gan.fakes", 5.0, []), ("gan.d_forward", 6.0, []),
        ("gan.r1", 7.0, []), ("gan.d_backward", 8.0, []),
        ("adam", 0.9, [])]),
}


def _ctx(steps: int | None) -> Context:
    trace = None if steps is None else Trace(ops=[], window_s=1.0,
                                             busy_s=1.0, steps=steps)
    return Context(cell="c", config={}, traffic={}, setup_s=1.0,
                   window_s=1.0, steps=4, items=4, step_ms=[], parts_ms={},
                   trace=trace, traced_steps=4)


def _own_ms(tree, names, scale) -> float:
    name, ms, children = tree
    own = scale * ms if name in names else 0.0
    return own + sum(_own_ms(c, names, scale) for c in children)


@pytest.fixture
def store(monkeypatch):
    """Three occurrences of each root recorded on a clock that moves only
    as the tree says."""
    clock = [0]
    monkeypatch.setattr(D.time, "perf_counter_ns", lambda: clock[0])

    def record(tree, scale):
        name, ms, children = tree
        with D.span(name):
            clock[0] += round(scale * ms * 1e6)
            for c in children:
                record(c, scale)

    D.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for scale in (1, 2, 3):
            for tree in TREES.values():
                record(tree, scale)
    yield
    D.reset_spans()


@pytest.mark.parametrize("metric", list(METRICS))
def test_nothing_to_read_reads_none(metric):
    D.reset_spans()
    reader = REG.reader(metric)
    assert reader.read(_ctx(None)) is None
    assert reader.read(_ctx(0)) is None
    assert reader.read(_ctx(2)) is None


@pytest.mark.parametrize("metric", list(METRICS))
def test_reads_the_first_traced_roots_only(store, metric):
    """The mean over the first ``ctx.trace.steps`` roots of the spans the
    metric names (occurrences 1 and 2: a mean scale of 1.5); the third,
    like the host-traced sub-window's, is not read."""
    root, names = METRICS[metric]
    want = _own_ms(TREES[root], names, 1.5)
    assert want > 0
    reader = REG.reader(metric)
    assert reader.read(_ctx(2)) == pytest.approx(want)
    assert reader.read(_ctx(1)) == pytest.approx(want / 1.5)
    assert metric in {m["name"] for m in REG.bench["per_layer"]}

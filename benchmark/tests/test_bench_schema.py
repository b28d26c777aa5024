"""A run's result line, its metrics' readers and the trace's reduction."""

from __future__ import annotations

import json
import math

import pytest

from benchmark.harness import readers, trace
from benchmark.harness.cell import Context
from benchmark.harness.registry import Registry

REG = Registry()
CELLS = [w["name"] for w in REG.bench["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_gives_the_result_line(run_tiny, cell):
    result = run_tiny(cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    want = {m["name"]: m["unit"] for m in REG.metrics(cell, False)}
    assert set(result["metrics"]) <= set(want) and "setup_s" in \
        result["metrics"]
    for name, m in result["metrics"].items():
        assert m["unit"] == want[name] and math.isfinite(m["value"])
    limits = REG.workload(cell)["limits"]
    assert list(result["checks"]) == list(limits)
    for name, c in result["checks"].items():
        assert c["limit"] == limits[name] and c["value"] <= c["limit"]
    json.dumps(result)


class _Profile:
    """Stands in for a finished torch.profiler run."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _kernel(name, ts, dur):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _host(name, ts, dur, cat="cpu_op"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    port = "void (anonymous namespace)::nerf_fwd_tc_kernel<true>(int)"
    events = [
        _host(trace.WINDOW, 1000, 1000, "user_annotation"),
        _host("bench.step", 1000, 500, "user_annotation"),
        _host("bench.step", 1500, 500, "user_annotation"),
        _host("aten::item", 990, 150),
        _host("aten::mm", 1590, 50),
        _kernel(port, 1200, 200),
        _kernel("ampere_sgemm_128x64_nn", 1300, 300),   # overlaps the first
        _kernel("ampere_sgemm_128x64_nn", 1800, 100),
        _kernel("outside the window", 2500, 100),
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1950, "dur": 10},
    ]
    gaps = dict(trace.idle_gaps(_Profile(events)))
    assert gaps["bench.step/aten::item"] == pytest.approx(2e-4)
    assert sum(gaps.values()) == pytest.approx(1e-3 - 510e-6)
    device_only = [e for e in events if e["cat"] not in trace.HOST_CATS
                   and e["ts"] < 2000]
    t = trace.reduce(_Profile(device_only), steps=2, window_s=1e-3)
    assert t.window_s == 1e-3
    assert t.busy_s == pytest.approx((400 + 100 + 10) * 1e-6)
    assert t.top_ops()[0] == ["ampere_sgemm_128x64_nn", pytest.approx(4e-4)]
    assert t.op_seconds(trace.is_port_kernel) == pytest.approx(2e-4)
    ctx = Context(cell="c", config={}, traffic={}, setup_s=1.0,
                  window_s=1.0, steps=4, items=8,
                  step_ms=[1.0, 2.0, 3.0, 4.0], parts_ms={"a": [1, 2, 3, 9]},
                  trace=t, traced_steps=2)
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 0.51))
    assert readers.plain_ms(ctx) == pytest.approx(1e3 * 4.1e-4 / 2)
    assert readers.mean_ms(ctx, "a") == pytest.approx(6.0)
    # least 0.1 ms of the port kernel's 0.2 ms a step (two steps traced)
    assert readers.roofline(ctx, {"bf16": 989.4e12 * 1e-4}, 0.0,
                            ["nerf_fwd"]) == pytest.approx(100.0)
    assert readers.roofline(ctx, {"bf16": 1.0}, 0.0, ["no_such"]) is None
    assert readers.mfu(ctx, {"fp32": 494.7e12 * 5e-4}) == pytest.approx(100)


def test_readers_without_a_trace_read_nothing():
    ctx = Context(cell="c", config={}, traffic={}, setup_s=1.0, window_s=2.0,
                  steps=4, items=8, step_ms=[float(i) for i in range(1, 101)],
                  parts_ms={})
    assert readers.rate(ctx) == 4.0
    assert readers.percentile(ctx.step_ms, 95) == pytest.approx(95.05)
    for fn in (readers.idle_share, readers.plain_ms):
        assert fn(ctx) is None
    assert readers.mfu(ctx, {"bf16": 1.0}) is None

"""One run of one cell: set-up, the measured window, the traced sub-windows,
the comparison that decides ``correct``, the metrics and the result line.

The window opens on an idle device once set-up (which runs the cell's first
steps and its warm-up) is done, and closes after the step during which
``seconds`` of host time have passed, once the device has finished it.  A
CUDA event is recorded on the stream at every step boundary and at every
part the driver marks, without a synchronise, so a stall shows in its step.

With ``trace`` the window begins with three sub-windows, each opening and
closing on an idle device: ``profile_steps`` steps under ``torch.profiler``
tracing the device alone (the per-layer metrics' trace: host-side tracing
would slow the host several-fold), ``label_steps`` steps tracing host and
device (to name the idle gaps by what the host was doing), and
``enqueue_steps`` steps each started on an idle device with the host's clock
over the step call.  The window then runs on untraced to its end.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import compare
from .registry import Registry
from .trace import WINDOW, Trace, idle_gaps, reduce

SUB_WINDOWS = ("profile_steps", "label_steps", "enqueue_steps")


@dataclass
class Context:
    """What a metric's reader reads."""
    cell: str
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    steps: int
    items: int
    step_ms: list
    parts_ms: dict
    trace: Trace | None = None
    enqueue_ms: list = field(default_factory=list)
    traced_steps: int = 0


class _Clock:
    """Points in time on the device's stream (CUDA events) or, on the CPU,
    the host's clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Traces:
    """The traced sub-windows of a ``--trace 1`` run, by step index."""

    def __init__(self, traffic: dict, on: bool, device):
        n = [int(traffic.get(k, 0)) if on else 0 for k in SUB_WINDOWS]
        self.profile_end = n[0]
        self.label_end = n[0] + n[1]
        self.end = sum(n)
        self.device = device
        self.enqueue_ms: list = []
        self.trace = self._prof = self._span = None
        self._gaps: list = []

    def before(self, i: int):
        if i == 0 and self.profile_end:
            _sync(self.device)
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._t_prof = time.perf_counter()
        if i == self.profile_end and self.label_end > i:
            _sync(self.device)
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._span = record_function(WINDOW)
            self._span.__enter__()
        if self.label_end <= i < self.end:
            _sync(self.device)
            self._t_call = time.perf_counter()

    def after(self, i: int):
        """After step ``i`` has been enqueued."""
        done = i + 1
        if self.label_end <= i < self.end:
            self.enqueue_ms.append(1e3 * (time.perf_counter()
                                          - self._t_call))
        if done == self.profile_end:
            _sync(self.device)
            window_s = time.perf_counter() - self._t_prof
            self._prof.__exit__(None, None, None)
            self.trace = reduce(self._prof, self.profile_end, window_s)
            self._prof = None
        if done == self.label_end and self._span is not None:
            _sync(self.device)
            self._span.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self._gaps = idle_gaps(self._prof)
            self._prof = self._span = None

    def result(self) -> Trace | None:
        if self.trace is not None:
            self.trace.idle_gaps = self._gaps
        return self.trace


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             start_time: float, device: str = "cuda", sut: str = "program",
             registry: Registry | None = None, overrides=None) -> dict:
    """The result of one run (the result line's keys, ``checks`` last).
    ``start_time`` is the process's start on ``time.time()``'s clock.
    ``sut`` puts a control or a fault in the program's place and
    ``overrides`` ({"config": {...}, "traffic": {...}}) cuts the sizes, both
    for the tests only."""
    reg = registry or Registry()
    wl = reg.workload(cell)
    cfg = dict(reg.config(wl["config"]))
    traffic = dict(reg.traffic(wl["traffic"]))
    for part, extra in (overrides or {}).items():
        {"config": cfg, "traffic": traffic}[part].update(extra)
    # the settings the configuration states (read at call time by the port)
    os.environ.update(cfg.get("env", {}))
    dev = torch.device(device)
    drv = reg.driver(traffic["driver"]).Driver(cfg, traffic, seed, dev, sut)
    t_setup = time.time()
    drv.setup()
    _sync(dev)
    print(f"set-up: {t_setup - start_time:.3f} s to the driver, "
          f"{time.time() - t_setup:.3f} s in it", file=sys.stderr)
    clock = _Clock(dev)
    bounds: list = []
    marks: list = []            # (step, part, point in time)

    def mark(part):
        marks.append((len(bounds) - 1, part, clock.now()))

    traces = _Traces(traffic, trace, dev)
    _sync(dev)
    setup_s = time.time() - start_time
    t_open = time.perf_counter()
    bounds.append(clock.now())
    i = 0
    while i < traces.end or time.perf_counter() - t_open < seconds:
        traces.before(i)
        with record_function(f"bench.{drv.unit}"):
            drv.step(i, mark)
        traces.after(i)
        bounds.append(clock.now())
        i += 1
    _sync(dev)
    window_s = time.perf_counter() - t_open
    attempted, failed = drv.outcome()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    step_ms = [clock.ms(a, b) for a, b in zip(bounds[:-1], bounds[1:])]
    parts_ms: dict = {}
    for k, (step, part, t) in enumerate(marks):
        nxt = marks[k + 1] if k + 1 < len(marks) else None
        end = nxt[2] if nxt is not None and nxt[0] == step \
            else bounds[step + 1]
        parts_ms.setdefault(part, []).append(clock.ms(t, end))
    del bounds, marks
    traced = traces.result()

    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = drv.readings()
    correct, checks = compare.verdict(readings, wl["limits"])
    correct = correct and failed == 0 and attempted > 0

    ctx = Context(cell=cell, config=cfg, traffic=traffic, setup_s=setup_s,
                  window_s=window_s, steps=i, items=i * drv.items_per_step,
                  step_ms=step_ms, parts_ms=parts_ms, trace=traced,
                  enqueue_ms=traces.enqueue_ms, traced_steps=traces.end)
    metrics = {}
    for entry in reg.metrics(cell, trace):
        value = reg.reader(entry["name"]).read(ctx)
        if value is not None and math.isfinite(value):
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(wl["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if traced is not None:
        device_info.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = {"device_ops": traced.top_ops(),
                               "idle_gaps": traced.idle_gaps}
    result["checks"] = checks
    return result

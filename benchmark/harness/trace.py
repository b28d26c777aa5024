"""The reduction of ``torch.profiler`` windows to device times.

Busy time is the union of the device operations' intervals in a window
that opens and closes on an idle device, the idle share is 1 - busy /
window, and the port's kernels are told apart by namespace (the anonymous
namespace of ``csrc/*.cu`` and ``tile_mm``).  In a window that also traces
the host, inside its ``bench.window`` span, each idle gap is named by what
the host was doing when it began: the innermost host operation open at that
instant, under the benchmark's innermost ``bench.*`` annotation.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bench.window"
PORT_PREFIXES = ("void (anonymous namespace)::", "(anonymous namespace)::",
                 "tile_mm::", "void tile_mm::")
TOP = 10
GAPS_NAMED = 400


def is_port_kernel(name: str) -> bool:
    """A kernel of the port's ``csrc/*.cu``, not one of PyTorch's, cuBLAS's
    or cuDNN's."""
    return name.startswith(PORT_PREFIXES)


@dataclass
class Trace:
    """The device operations (name, start s, duration s) of a traced window
    of ``steps`` steps, its length and its busy time in seconds, and the
    idle gaps by the host's activity ([name, seconds], longest first)."""
    ops: list
    window_s: float
    busy_s: float
    steps: int
    idle_gaps: list = field(default_factory=list)

    def op_seconds(self, match) -> float:
        """Seconds of the operations whose names ``match(name)`` accepts."""
        return sum(d for n, _, d in self.ops if match(n))

    def top_ops(self, n: int = TOP) -> list:
        by_name: dict = {}
        for name, _, d in self.ops:
            by_name[name] = by_name.get(name, 0.0) + d
        return [[k, v] for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _device_ops(events, t0=float("-inf"), t1=float("inf")) -> list:
    return sorted(((e["name"], e["ts"], e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS and "dur" in e
                   and t0 <= e["ts"] < t1), key=lambda o: o[1])


def _merge(intervals) -> list:
    """Sorted disjoint [start, end] of the union."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def reduce(prof, steps: int, window_s: float) -> Trace:
    """A finished device-only profiler run over a window of ``steps`` steps
    that took ``window_s`` seconds on the host's clock, opening and closing
    on an idle device (so every operation of the run lies inside it)."""
    ops = _device_ops(_events(prof))
    busy_us = sum(hi - lo for lo, hi in _merge((ts, ts + d)
                                               for _, ts, d in ops))
    t0 = ops[0][1] if ops else 0.0
    return Trace(ops=[(n, (ts - t0) / 1e6, d / 1e6) for n, ts, d in ops],
                 window_s=window_s, busy_s=busy_us / 1e6, steps=steps)


def _label(t, host, starts, marks) -> str:
    """The innermost host operation open at ``t`` under its bench.* mark."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 4000), -1):
        name, ts, dur = host[j]
        if ts + dur > t and (best is None or dur < best[2]):
            best = host[j]
    mark = next((n for n, ts, d in marks if ts <= t < ts + d), "")
    op = best[0] if best is not None else "idle host"
    return f"{mark}/{op}" if mark else op


def idle_gaps(prof) -> list:
    """[name, seconds] of the device's idle time inside the ``bench.window``
    span of a finished host-and-device profiler run, summed by what the
    host was doing as each gap began (the longest gaps), longest first."""
    events = _events(prof)
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e]
    if not win:
        return []
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    busy = _merge((ts, min(ts + d, t1))
                  for _, ts, d in _device_ops(events, t0, t1))
    gaps, prev = [], t0
    for lo, hi in busy:
        if lo > prev:
            gaps.append((lo - prev, prev))
        prev = max(prev, hi)
    if t1 > prev:
        gaps.append((t1 - prev, prev))
    host = sorted(((e["name"], e["ts"], e["dur"]) for e in events
                   if e.get("cat") in HOST_CATS and "dur" in e
                   and not e["name"].startswith("bench.")),
                  key=lambda h: h[1])
    starts = [h[1] for h in host]
    marks = sorted(((e["name"], e["ts"], e["dur"]) for e in events
                    if e.get("cat") == "user_annotation" and "dur" in e
                    and e["name"].startswith("bench.")
                    and e["name"] != WINDOW), key=lambda m: m[2])
    by_label: dict = {}
    for length, at in sorted(gaps, reverse=True)[:GAPS_NAMED]:
        key = _label(at, host, starts, marks)
        by_label[key] = by_label.get(key, 0.0) + length / 1e6
    return [[k, v] for k, v in sorted(by_label.items(),
                                      key=lambda kv: -kv[1])[:TOP]]

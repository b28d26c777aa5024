"""Tracing, NaN debugging and hang detection (port of
``msra_practice_project_tpu/core/diagnostics.py``), each opt-in per config:

  * ``profile_steps: N``    -> ``StepProfiler``: a ``torch.profiler`` trace
                               (CPU and, on the card, CUDA activity) of N
                               steps after the first 10, as a Chrome trace
                               under ``<log_dir>/profile/``.
  * ``debug_nans: true``    -> ``enable_from_config``: autograd's anomaly
                               mode (the counterpart of ``jax_debug_nans``:
                               the backward function that made a NaN is
                               named, with the forward's traceback) and a
                               host check of each step's loss; both raise
                               ``FloatingPointError``.  Off by default:
                               anomaly mode slows every step.
  * ``watchdog_timeout: S`` -> ``Watchdog``: if the watched loop stops
                               heartbeating for S seconds, the process
                               hard-exits with code 17 so a supervisor
                               (``tools/supervise.py``) can restart it;
                               checkpoint resume makes the restart lossless.
The reference has no failure detection at all.

Spans (``span``, ``span_steps``, ``reset_spans``) time the stages inside
the train steps and the render library while a ``torch.profiler`` records:
the benchmark's traced sub-windows, or ``StepProfiler``'s window, which
prints them as a table per step.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import torch
from torch.autograd import profiler as _profiler


class NanDebug:
    """``debug_nans`` for one training loop: a context manager that turns
    autograd's anomaly mode on for its block (and restores the previous
    mode after it), plus ``check``, a host check of a step's scalars.

    Anomaly mode raises a ``RuntimeError`` from the first backward function
    that returns NaN (the fused kernels' ``autograd.Function``s included);
    leaving the block re-raises it as ``FloatingPointError``, the error
    ``check`` and ``jax_debug_nans`` raise.  Disabled, both are no-ops and
    ``check`` never waits for the device."""

    def __init__(self, enabled: bool):
        self.enabled = bool(enabled)
        self._mode = None

    def __enter__(self):
        if self.enabled:
            self._mode = torch.autograd.set_detect_anomaly(True)
        return self

    def __exit__(self, typ, exc, tb):
        if self._mode is not None:
            self._mode.__exit__(None, None, None)
            self._mode = None
        if (self.enabled and isinstance(exc, RuntimeError)
                and "nan values" in str(exc)):
            raise FloatingPointError(f"debug_nans: {exc}") from exc
        return False

    def check(self, step: int, **values) -> None:
        """Raise ``FloatingPointError`` if a value is not finite."""
        if not self.enabled:
            return
        for name, v in values.items():
            if not bool(torch.isfinite(torch.as_tensor(v)).all()):
                raise FloatingPointError(
                    f"debug_nans: {name} is {float(v)} at step {step}")


def enable_from_config(config) -> NanDebug:
    """``debug_nans`` from config (off when absent)."""
    return NanDebug(config.get("debug_nans", False))


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

SPAN_ROOTS = 1000       # root occurrences the store keeps since its reset

# A range on the profiler's clock: the fast entry point where torch has it
# (~1 us a range against ~8 for ``record_function``, on the CPU).
_RANGE = (getattr(getattr(torch._C, "_profiler", None),
                  "_RecordFunctionFast", None)
          or torch.profiler.record_function)


class _NoSpan:
    """What ``span`` returns while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_lock = threading.Lock()
# The open spans, innermost last, of every thread: autograd runs a CUDA
# backward on its own thread while the caller waits in ``backward()``, and
# the spans opened there belong under the caller's.
_stack: list = []
_roots: list = []       # one list of spans per root occurrence, root first
_free_events: dict = {}  # CUDA device index -> timing events to reuse
_streams: dict = {}     # (stream id, device, type) -> its torch Stream


def _current_stream():
    """The current CUDA stream, without building a new ``Stream`` (and
    switching devices to do so) at every span."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream()
    return stream


def _record(ev, stream):
    """``ev`` (a new timing event where None) recorded on ``stream``."""
    if ev is None:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    __slots__ = ("name", "parent", "spans", "stream", "t0", "t1", "e0", "e1",
                 "_range")

    def __init__(self, name: str):
        self.name = name
        self.parent = self.spans = self.stream = None
        self.t1 = self.e0 = self.e1 = None

    def __enter__(self):
        stream = _current_stream() if torch.cuda.is_initialized() else None
        with _lock:
            up = _stack[-1] if _stack else None
            if up is not None:
                self.parent, self.spans = up.name, up.spans
            elif len(_roots) < SPAN_ROOTS:
                self.spans = []
                _roots.append(self.spans)
            if self.spans is not None:      # else past the bound: not kept
                self.spans.append(self)
                self.stream = stream
            if self.stream is not None:     # the pool holds events in pairs
                pool = _free_events.get(stream.device_index)
                if pool:
                    self.e1, self.e0 = pool.pop(), pool.pop()
            _stack.append(self)
        self._range = _RANGE(self.name)
        self._range.__enter__()
        if self.stream is not None:
            self.e0 = _record(self.e0, self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.stream is not None:
            self.e1 = _record(self.e1, self.stream)
        self._range.__exit__(*exc)
        with _lock:
            if _stack[-1] is self:
                _stack.pop()
            else:
                _stack.remove(self)
        return False

    def device_ms(self) -> float:
        """The stream's time from entry to exit (waits for the exit); the
        host's where CUDA was not in use, as CPU ops run as they are
        called."""
        if self.stream is None:
            return (self.t1 - self.t0) / 1e6
        self.e1.synchronize()
        return self.e0.elapsed_time(self.e1)


def span(name: str):
    """A context manager that times the block as the span ``name``, nested
    under the innermost span open in any thread; a span opened with none
    open is a root.  It records only while a ``torch.profiler`` records and
    no CUDA graph is being captured: its parent, the host's clock at entry
    and exit, two CUDA events on the current stream (never waited for
    here) and a range on the profiler's clock, so a host-and-device trace
    shows the span around its ops.  Otherwise it returns one shared no-op
    object."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    if (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing()):
        return _NO_SPAN
    return _Span(name)


def span_steps(root: str, n: int) -> dict | None:
    """``{name: {"parent", "count", "host_ms", "device_ms"}}`` over the
    first ``n`` finished occurrences of the root span ``root`` since the
    last reset: for each span name opened under them (the root's own
    included), its parent's name, and its entries, host ms and device ms
    summed within an occurrence and averaged over the occurrences.  None
    when no such root was recorded."""
    with _lock:
        found = [spans for spans in _roots
                 if spans[0].name == root and spans[0].t1 is not None][:n]
    if not found:
        return None
    out: dict = {}
    for spans in found:
        for s in spans:
            if s.t1 is None:
                continue
            e = out.setdefault(s.name, {"parent": s.parent, "count": 0.0,
                                        "host_ms": 0.0, "device_ms": 0.0})
            e["count"] += 1
            e["host_ms"] += (s.t1 - s.t0) / 1e6
            e["device_ms"] += s.device_ms()
    for e in out.values():
        for k in ("count", "host_ms", "device_ms"):
            e[k] /= len(found)
    return out


def reset_spans() -> None:
    """Empty the store; the CUDA events of its finished spans go back to the
    pool."""
    with _lock:
        for spans in _roots:
            for s in spans:
                if s.stream is not None and s.t1 is not None:
                    _free_events.setdefault(s.stream.device_index,
                                            []).extend((s.e0, s.e1))
        _roots.clear()


def _span_table() -> str:
    """The store as a table: per root name, each span's entries, host ms
    and device ms per occurrence of the root."""
    with _lock:
        roots: dict = {}
        for spans in _roots:
            roots[spans[0].name] = roots.get(spans[0].name, 0) + 1
    lines = []
    for root, n in roots.items():
        per = span_steps(root, n)
        if per is None:
            continue
        lines.append(f"spans per {root} ({n}): name, parent, entries, "
                     "host ms, device ms")
        lines += [f"  {name:<22} {e['parent'] or '-':<18} {e['count']:7.2f} "
                  f"{e['host_ms']:10.3f} {e['device_ms']:10.3f}"
                  for name, e in per.items()]
    return "\n".join(lines)


class StepProfiler:
    """Traces steps ``(skip, skip + steps]`` of a training loop with
    ``torch.profiler``, CPU activity and, for a CUDA ``device``, the card's.

    Usage::

        prof = StepProfiler(log_path, config.get("profile_steps", 0),
                            device=device)
        for step in ...:          # the 1-based step about to run
            prof.tick(step)
            ...
        prof.stop()

    The trace is written when the window ends (or at ``stop()``, if the
    loop ends first) to ``<log_path>/profile/trace_steps_<a>-<b>.json``, a
    Chrome trace (Perfetto, chrome://tracing); ``path`` names it.  The
    device is synchronised at both ends, so the window holds its steps'
    work and no other.  The window's spans (``span``) are in the trace, and
    their table is printed when it ends."""

    def __init__(self, log_path: str, steps: int = 0, skip: int = 10,
                 device=None):
        self.dir = os.path.join(log_path, "profile")
        self.steps, self.skip = int(steps), int(skip)
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.path = None
        self._prof = None
        self._done = self.steps <= 0

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def tick(self, step: int) -> None:
        if self._done:
            return
        if self._prof is None and step > self.skip:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self._sync()
            reset_spans()
            self._prof = profile(activities=acts)
            self._prof.start()
            self._start = self._last = step
        elif self._prof is not None and step >= self._start + self.steps:
            self._last = step - 1
            self.stop()
        elif self._prof is not None:
            self._last = step

    def stop(self) -> None:
        if self._prof is None:
            return
        self._sync()
        self._prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(
            self.dir, f"trace_steps_{self._start}-{self._last}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self._done = True
        print(f"[profile] trace written to {self.path}")
        table = _span_table()
        if table:
            print(table)


class Watchdog:
    """Hang detector for long device runs.

    A device call that never returns cannot be interrupted by a
    Python-level timeout, so recovery is process-level: a daemon thread
    watches a heartbeat the loop touches every iteration, and if it goes
    stale for ``timeout_s`` seconds the process hard-exits with
    :data:`EXIT_CODE`.

    ``timeout_s <= 0`` disables the watchdog (no thread started); every
    method stays callable, so call sites need no conditionals.  Pick a
    timeout larger than the longest legitimate gap between heartbeats.
    """

    EXIT_CODE = 17

    def __init__(self, timeout_s: float, log_path: str | None = None):
        self.timeout = float(timeout_s)
        self.log_path = log_path
        self._last = time.monotonic()
        self._note = ""
        self._paused = False
        self._stop_evt = threading.Event()
        self._thread = None
        if self.timeout > 0:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="msra-torch-watchdog")
            self._thread.start()

    @property
    def enabled(self) -> bool:
        return self._thread is not None

    def beat(self, note: str = "") -> None:
        """Mark liveness (call once per host-visible loop iteration)."""
        self._note = note
        self._last = time.monotonic()

    def pause(self) -> None:
        """Blind the watchdog during a long host-side phase that cannot
        wedge on the device; resume() re-arms it (the thread stays)."""
        self._paused = True

    def resume(self) -> None:
        self._last = time.monotonic()
        self._paused = False

    def stop(self) -> None:
        """Disarm (call when leaving the watched region)."""
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def _run(self) -> None:
        poll = max(min(self.timeout / 4.0, 5.0), 0.05)
        while not self._stop_evt.wait(poll):
            if self._paused:
                continue
            stalled = time.monotonic() - self._last
            if stalled > self.timeout:
                msg = (f"[watchdog] no heartbeat for {stalled:.0f}s "
                       f"(timeout {self.timeout:.0f}s): device presumed "
                       f"wedged (last note: {self._note!r}); exiting with "
                       f"code {self.EXIT_CODE} for a supervised restart\n")
                sys.stderr.write(msg)
                sys.stderr.flush()
                if self.log_path:
                    try:
                        with open(os.path.join(self.log_path,
                                               "watchdog.log"), "a") as f:
                            f.write(msg)
                    except OSError:
                        pass
                os._exit(self.EXIT_CODE)


def watchdog_from_config(config, log_path: str | None = None) -> Watchdog:
    """``watchdog_timeout`` seconds from config; 0/absent = disabled."""
    return Watchdog(float(config.get("watchdog_timeout", 0)), log_path)

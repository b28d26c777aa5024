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
"""

from __future__ import annotations

import os
import sys
import threading
import time

import torch


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
    work and no other."""

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

"""Hang detection for long device runs (port of the ``Watchdog`` and
``watchdog_from_config`` of ``msra_practice_project_tpu/core/diagnostics.py``).

``watchdog_timeout: S`` in a config arms a watchdog: if the watched loop
stops heartbeating for S seconds, the process hard-exits with code 17 so a
supervisor can restart it; checkpoint resume makes the restart lossless.
The reference has no failure detection at all.

The JAX module's step profiler and NaN debugging are not ported yet.
"""

from __future__ import annotations

import os
import sys
import threading
import time


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

"""Training observability: per-step metric history and prints (port of
``msra_practice_project_tpu/core/logging.py``).

Appends are lazy: device scalars are stored as they are and converted to
floats in one batch at print/save cadence, so the loop does not wait for the
device on every step.  The history is saved as ``log.npy``, as the reference
does.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch


class MetricLogger:
    def __init__(self, keys):
        self._data = {k: [] for k in keys}
        self._flushed = {k: 0 for k in keys}   # prefix already floats
        self._t0 = time.perf_counter()
        self._last = self._t0

    def preload(self, data: dict, n: int | None = None):
        """Seed the history from a saved log (resume), keeping the first
        `n` entries per key (all when n is None)."""
        for k in self._data:
            vs = [float(x) for x in data.get(k, [])]
            self._data[k] = vs if n is None else vs[:n]
            self._flushed[k] = len(self._data[k])

    def append(self, **kv):
        """One entry per key: a scalar (tensor or float)."""
        for k, v in kv.items():
            self._data[k].append(v.detach() if torch.is_tensor(v) else v)

    def flush(self):
        for k, vs in self._data.items():
            start = self._flushed[k]
            pend = vs[start:]
            if not pend:
                continue
            dev = next((v.device for v in pend if torch.is_tensor(v)), "cpu")
            flat = torch.stack([
                torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())
                for v in pend]).cpu()   # one transfer per key
            self._data[k] = vs[:start] + flat.tolist()
            self._flushed[k] = len(self._data[k])

    @property
    def data(self) -> dict:
        self.flush()
        return self._data

    def step_time(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        return dt

    def save(self, log_path: str, name: str = "log.npy") -> str:
        self.flush()
        os.makedirs(log_path, exist_ok=True)
        path = os.path.join(log_path, name)
        np.save(path, self._data)
        return path

    @staticmethod
    def load(path: str) -> dict:
        return np.load(path, allow_pickle=True).item()


def flush_scalar_list(vs: list) -> list:
    """A list of Python floats followed by pending device scalars -> all
    floats, with one device-to-host transfer for the pending ones."""
    start = next((i for i, v in enumerate(vs) if not isinstance(v, float)),
                 len(vs))
    pend = vs[start:]
    if not pend:
        return vs
    dev = next((v.device for v in pend if torch.is_tensor(v)), "cpu")
    flat = torch.cat([torch.as_tensor(v, dtype=torch.float32,
                                      device=dev).reshape(-1)
                      for v in pend]).cpu()
    return vs[:start] + flat.tolist()


def log_print(msg: str):
    print(msg, flush=True)

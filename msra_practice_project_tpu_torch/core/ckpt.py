"""Checkpointing: step-stamped snapshots with scan-resume (port of
``msra_practice_project_tpu/core/ckpt.py``).

``<log_path>/{step:06d}.ckpt`` files in ``torch.save`` format, published
atomically (temporary file, fsync, rename).  Resume loads the newest readable
snapshot.  Checkpoints of the JAX package (msgpack) are not read.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

CKPT_SUFFIX = ".ckpt"
_STEP_RE = re.compile(r"^(\d{6,})" + re.escape(CKPT_SUFFIX) + r"$")


def ckpt_path(log_path: str, step: int) -> str:
    return os.path.join(log_path, f"{step:06d}{CKPT_SUFFIX}")


def save(log_path: str, step: int, state: Any) -> str:
    """Write ``state`` (tensors, dicts, numbers) to
    ``<log_path>/<step:06d>.ckpt``."""
    os.makedirs(log_path, exist_ok=True)
    path = ckpt_path(log_path, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())  # durable before the rename publishes it
    os.replace(tmp, path)     # a crash never leaves a torn checkpoint
    return path


def list_checkpoints(log_path: str) -> list[tuple[int, str]]:
    """All (step, path) snapshots in ascending step order."""
    if not os.path.isdir(log_path):
        return []
    out = []
    for f in os.listdir(log_path):
        m = _STEP_RE.match(f)
        if m:
            out.append((int(m.group(1)), os.path.join(log_path, f)))
    return sorted(out)


def latest(log_path: str) -> tuple[int, str] | None:
    cks = list_checkpoints(log_path)
    return cks[-1] if cks else None


def restore(path: str, map_location=None) -> Any:
    """Load a snapshot this program wrote."""
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_latest(log_path: str, map_location=None) -> tuple[int, Any] | None:
    """Resume-by-scan: the newest readable snapshot, falling back to older
    ones when the newest does not load (torn by a power or OS crash)."""
    for step, path in reversed(list_checkpoints(log_path)):
        try:
            return step, restore(path, map_location)
        except (OSError, RuntimeError, EOFError, ValueError) as e:
            print(f"[ckpt] {path} unreadable ({type(e).__name__}: {e}); "
                  "falling back to the previous snapshot")
    return None

"""Checkpointing: step-stamped snapshots with scan-resume (port of
``msra_practice_project_tpu/core/ckpt.py``).

``<log_path>/{step:06d}.ckpt`` files in ``torch.save`` format, published
atomically (temporary file, fsync, rename).  Resume loads the newest readable
snapshot.  ``restore`` also reads the JAX package's snapshots (flax msgpack,
same names) as raw trees; ``weights.train_state_from_jax`` turns those into
the port's layout.  Which one a file holds is read from its first bytes.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

from . import msgpack_read

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


class UnknownFormat(Exception):
    """A checkpoint file in neither format: raised, never skipped, so a run
    does not quietly start afresh beside a snapshot it cannot read."""


def restore(path: str, map_location=None) -> Any:
    """Load a snapshot: the port's (a zip from ``torch.save``) with its
    tensors on ``map_location``, or the JAX package's (flax msgpack) as a raw
    tree of dicts, numbers and CPU tensors.  An empty or truncated file
    raises ``EOFError`` / ``ValueError`` / ``RuntimeError``; any other
    format, or a msgpack file holding a value the reader does not decode,
    ``UnknownFormat``."""
    with open(path, "rb") as f:
        head = f.read(4)
        if not head:
            raise EOFError(f"{path} is empty")
        if head == b"PK\x03\x04":
            f.seek(0)
            return torch.load(f, map_location=map_location,
                              weights_only=True)
        if msgpack_read.is_map_start(head):
            f.seek(0)
            try:
                return msgpack_read.loads(f.read())
            except msgpack_read.Unsupported as e:
                raise UnknownFormat(f"{path}: {e}") from e
    raise UnknownFormat(f"{path} starts with {head!r}: neither a torch.save "
                        "zip nor a flax msgpack map")


def restore_latest(log_path: str, map_location=None) -> tuple[int, Any] | None:
    """Resume-by-scan: the newest readable snapshot, falling back to older
    ones when the newest does not load (torn by a power or OS crash).  A
    file of unknown format, or one whose values cannot be decoded, raises
    (``UnknownFormat``)."""
    for step, path in reversed(list_checkpoints(log_path)):
        try:
            return step, restore(path, map_location)
        except (OSError, RuntimeError, EOFError, ValueError) as e:
            print(f"[ckpt] {path} unreadable ({type(e).__name__}: {e}); "
                  "falling back to the previous snapshot")
    return None

"""Restart-durable artifact root for long runs (port of
``msra_practice_project_tpu/core/artifacts.py``).

Host restarts can wipe ``/tmp`` and ``~/.cache``, and resume-by-scan is
useless when the experiment directory itself is gone, so long-running tools
put checkpoints, logs and sample grids under a durable root by default.

``durable_root()`` resolves, in order:
  1. the ``MSRA_TPU_RUN_ROOT`` environment variable (explicit override),
  2. ``<repo>/runs``: the directory holding this package (gitignored).

``run_dir(name)`` returns (and creates) a subdirectory for one experiment
family, e.g. ``run_dir("pigan_validate")``.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def durable_root() -> str:
    root = os.environ.get("MSRA_TPU_RUN_ROOT") or \
        os.path.join(_REPO_ROOT, "runs")
    os.makedirs(root, exist_ok=True)
    return root


def run_dir(name: str) -> str:
    path = os.path.join(durable_root(), name)
    os.makedirs(path, exist_ok=True)
    return path

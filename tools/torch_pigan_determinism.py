#!/usr/bin/env python3
"""Is pi-GAN training with the PyTorch/CUDA port reproducible run to run?

Trains msra_practice_project_tpu_torch on configs/pi_gan/test.json at stage 0
(batch 64 at 32x32, trunk mode MSRA_TPU_FUSED_FILM, default 1) for a few
iterations, twice with PyTorch's default cuDNN settings and twice with
``torch.backends.cudnn.deterministic = True``.  For each setting it prints
whether the two runs' losses and final parameters are bitwise equal, the
first iteration whose losses differ, and ms per iteration over the last half
of each run (one CUDA-event window).  Needs one NVIDIA GPU.

Run from the repository root:  python3 tools/torch_pigan_determinism.py [iterations]
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from msra_practice_project_tpu_torch.core.config import (  # noqa: E402
    CONFIG_ROOT, PIGAN_TRAIN_DEFAULTS, load_config, resolve)
from msra_practice_project_tpu_torch.train import train_pigan  # noqa: E402


def run(n_it: int):
    """(loss log, all parameters flattened, ms per iteration)."""
    cfg = resolve(load_config(os.path.join(CONFIG_ROOT, "pi_gan",
                                           "test.json")), PIGAN_TRAIN_DEFAULTS)
    timed = n_it // 2
    with tempfile.TemporaryDirectory(prefix="pigan_det_") as out_dir:
        cfg.update(output_path=out_dir, experiment_name="det",
                   iterations=[n_it], fade_in_itrs=[0], batch_size=[64],
                   resolution=[32], i_print=n_it, i_save=10 ** 9,
                   i_image=10 ** 9)
        res = train_pigan.train(cfg, timed_steps=timed)
        params = torch.cat([p.detach().flatten() for m in (
            res["generator"], res["discriminator"]) for p in m.parameters()])
    return res["loss_log"], params, res["window_ms"] / timed


def first_difference(a: dict, b: dict):
    """The first (iteration, loss name) whose values differ, or None."""
    for i, pair in enumerate(zip(zip(a["d_loss"], a["g_loss"]),
                                 zip(b["d_loss"], b["g_loss"]))):
        for name, x, y in zip(("d_loss", "g_loss"), *pair):
            if x != y:
                return i + 1, name
    return None


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    n_it = int(argv[0]) if argv else 6
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"trunk mode {os.environ.get('MSRA_TPU_FUSED_FILM', '1')}, "
          f"{n_it} iterations per run", flush=True)
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        (la, pa, ms_a), (lb, pb, ms_b) = run(n_it), run(n_it)
        print(f"cudnn.deterministic={deterministic}: losses bitwise equal "
              f"{la == lb}, parameters bitwise equal {torch.equal(pa, pb)} "
              f"(max |diff| {float((pa - pb).abs().max()):.3e}), first "
              f"difference {first_difference(la, lb)}; ms/iteration "
              f"{ms_a:.3f}, {ms_b:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""End-to-end SIREN image-fit quality gate for the PyTorch/CUDA port (the
counterpart of tools/validate_img.py).

Trains the image-regression pipeline (the reference's cameraman workload,
siren/train_img.py) through ``train_img.train`` on a band-limited
synthetic image and checks the full-grid reconstruction PSNR: SIREN must
exceed 40 dB and the ReLU+PE ablation 28 dB.  ``--real`` fits
grace_hopper.jpg instead (the JAX tool's photo, matplotlib's sample data,
read from the port's copy in data/sample_data/), with the JAX tool's lower
bars (28 and 23 dB).  Exit code 1 when a bar is missed.

Run: python3 tools/torch_validate_img.py [iterations] [size] [--real]
         [--device cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from msra_practice_project_tpu_torch.core.config import (  # noqa: E402
    SIREN_IMG_DEFAULTS, resolve)
from msra_practice_project_tpu_torch.data import SAMPLE_DATA  # noqa: E402
from msra_practice_project_tpu_torch.train.train_img import (  # noqa: E402
    render_grid, train)

BARS_DB = {"siren": 40.0, "relu_pe": 28.0}
# Real-photo bars (grace_hopper.jpg, 512x600), the JAX tool's: a natural
# photograph has far more high-frequency content than the band-limited
# synthetic target, so the bars are lower at the same iteration count.
BARS_REAL_DB = {"siren": 28.0, "relu_pe": 23.0}


def real_photo_path() -> str:
    """A real photograph shipped offline: the port's copy of matplotlib's
    grace_hopper.jpg (data/sample_data/; the reference's workload is the
    same single-photo regression on cameraman.jpg, siren/train_img.py:32).
    Raises when the file is missing."""
    path = os.path.join(SAMPLE_DATA, "grace_hopper.jpg")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def run_one(model_type: str, iterations: int, size: int, base: str,
            data_path: str = "/nonexistent", device=None,
            overrides=None) -> dict:
    """Train one backbone afresh; returns its full-grid PSNR, the log path
    and ms per step (the train steps' own window)."""
    exp = f"exp_{model_type}"
    # a fresh run every time: a checkpoint at `iterations` would resume into
    # a 0-step no-op and validate the previous run
    shutil.rmtree(os.path.join(base, exp), ignore_errors=True)
    cfg = resolve({
        "output_path": base, "experiment_name": exp,
        "model_type": model_type, "iterations": iterations,
        "batch_size": 16384, "data_size": size, "data_path": data_path,
        "i_print": max(iterations // 4, 1), "i_save": iterations,
        "i_image": iterations, **(overrides or {}),
    }, SIREN_IMG_DEFAULTS)
    out = train(cfg, device=device, timed_steps=iterations)
    # full-grid reconstruction against the exact target (not the batch)
    recon = render_grid(out["model"], out["width"],
                        out["height"]).cpu().numpy()
    target = np.asarray(out["image"])[..., 0]
    psnr = float(-10.0 * np.log10(np.mean((recon - target) ** 2)))
    print(f"[validate] {model_type}: full-grid PSNR {psnr:.2f} dB "
          f"({target.shape[0]}x{target.shape[1]} target)", flush=True)
    return {"psnr": psnr, "log_path": os.path.join(base, exp),
            "ms_per_step": out["window_ms"] / iterations}


def main(iterations=1500, size=64, real=False, device=None, out_dir=None,
         overrides=None) -> dict:
    """Fit every backbone with a bar.  Returns {"ok", "bars", "psnr":
    {kind: dB}, "log_paths": {kind: dir}, "ms_per_step": {kind: ms}};
    ``overrides`` replaces keys of the training config (smaller runs)."""
    base = out_dir or os.path.join(tempfile.gettempdir(),
                                   "img_validate_torch")
    bars = BARS_REAL_DB if real else BARS_DB
    data_path = real_photo_path() if real else "/nonexistent"
    if real:
        print(f"[validate] real photo target: {data_path}")
    res = {"ok": True, "bars": bars, "psnr": {}, "log_paths": {},
           "ms_per_step": {}}
    for model_type, bar in bars.items():
        one = run_one(model_type, iterations, size, base, data_path, device,
                      overrides)
        print(f"[validate] {model_type}: bar {bar} dB")
        res["psnr"][model_type] = one["psnr"]
        res["log_paths"][model_type] = one["log_path"]
        res["ms_per_step"][model_type] = one["ms_per_step"]
        res["ok"] = res["ok"] and one["psnr"] > bar
    print("[validate]", "PASS" if res["ok"] else "FAIL",
          f"(siren > {bars['siren']} dB, relu_pe > "
          f"{bars['relu_pe']} dB full-grid reconstruction"
          f"{' on a real photograph' if real else ''})", flush=True)
    return res


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("iterations", nargs="?", type=int, default=1500)
    p.add_argument("size", nargs="?", type=int, default=64)
    p.add_argument("--real", action="store_true",
                   help="fit grace_hopper.jpg (data/sample_data/)")
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: CUDA)")
    p.add_argument("--out", default=None,
                   help="directory for the experiments "
                        "(default: <tmp>/img_validate_torch)")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args(sys.argv[1:])
    sys.exit(0 if main(a.iterations, a.size, a.real, a.device,
                       a.out)["ok"] else 1)

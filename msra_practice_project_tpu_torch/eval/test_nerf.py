"""NeRF evaluation sweep: render every train / val-in / val-ex view and score
it (port of ``msra_practice_project_tpu/eval/test_nerf.py``).

Per view: the angular distance to the nearest training region, PSNR, SSIM,
LPIPS (null without pretrained AlexNet weights) and a perceptual distance
that is always there (LPIPS, else 1 - MS-SSIM, labelled).  Writes
``test.json`` and a comparison strip ``test.jpg`` (renders beside truth).

Run: python -m msra_practice_project_tpu_torch.eval.test_nerf <log_dir>
     [ckpt_idx] [sample_multiplier] [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..core import diagnostics, image_io, metrics
from ..ops.rays import pose_to_camera_pos
from ..train.train_nerf import load_dataset
from .nerf_common import (generator_for, load_experiment, render_view,
                          split_device_flag)


def angular_distance(pose) -> float:
    """max(|theta|, |phi|) folded across the 180-degree seam
    (ref: nerf/test_nerf.py:104-105)."""
    _, theta, phi = pose_to_camera_pos(pose)
    if abs(theta) < 90:
        return max(abs(theta), abs(phi))
    return 180 - max(180 - abs(theta), abs(phi))


def run(log_path: str, ckpt_idx: int | None, sample_mult: float = 1.0,
        max_views: int | None = None, device=None):
    """Score up to ``max_views`` views per split; returns the test.json
    dict.  Runs on CUDA unless ``device='cpu'``."""
    config, models, _, step = load_experiment(log_path, ckpt_idx, device)
    images, poses, width, height, focal, _ = load_dataset(config)
    # A long sweep inherits the experiment's watchdog, with its timeout
    # floored at 900 s: the heartbeat is per view, and a slow first view
    # must not kill every supervised attempt.  The sweep is idempotent, so
    # a restart just renders again.
    t = float(config.get("watchdog_timeout", 0.0) or 0.0)
    watchdog = diagnostics.Watchdog(max(t, 900.0) if t > 0 else 0.0,
                                    log_path)

    data = {k: {"train": [], "in": [], "ex": []}
            for k in ["dist", "psnr", "ssim", "lpips", "perceptual"]}
    strips, targets = [], []
    generator = generator_for(models)
    weights_dir = config.get("lpips_weights_dir", None)
    perceptual_metric = None

    for split in ["train", "in", "ex"]:
        pairs = (zip(poses["train"], images["train"]) if split == "train"
                 else zip(poses["val"][split], images["val"][split]))
        for i, (pose, target) in enumerate(pairs):
            if max_views is not None and i >= max_views:
                break
            watchdog.beat(f"{split} view {i}")
            rgb, _, _ = render_view(config, models, width, height, focal,
                                    pose, generator, sample_mult)
            target_rgb = np.asarray(target[..., :3])
            dist = angular_distance(pose)
            psnr = metrics.psnr(rgb, target_rgb)
            ssim = metrics.ssim(rgb, target_rgb)
            lp = metrics.lpips(rgb, target_rgb, weights_dir)
            perc, perceptual_metric = metrics.perceptual_distance(
                rgb, target_rgb, weights_dir)
            data["dist"][split].append(dist)
            data["psnr"][split].append(psnr)
            data["ssim"][split].append(ssim)
            data["lpips"][split].append(lp)
            data["perceptual"][split].append(perc)
            strips.append(rgb)
            targets.append(target_rgb)
            print(f"[Test] {split} DIST: {dist:.2f} PSNR: {psnr:.3f} "
                  f"SSIM: {ssim:.4f} LPIPS: {lp} "
                  f"PERC({perceptual_metric}): {perc:.4f}")

    watchdog.stop()
    data["perceptual_metric"] = perceptual_metric
    test_file = os.path.join(log_path, "test.json")
    with open(test_file, "w") as f:
        json.dump(data, f)
    print(f"Test data write to: {test_file} (step {step})")

    strip = np.concatenate(
        [np.concatenate(strips, 0), np.concatenate(targets, 0)], 1)
    test_img = os.path.join(log_path, "test.jpg")
    image_io.imwrite(test_img, strip)
    print("Test image write to:", test_img)
    return data


def main(argv=None):
    argv, device = split_device_flag(
        argv if argv is not None else sys.argv[1:])
    if not argv:
        raise SystemExit("usage: test_nerf <log_dir> [ckpt_idx] "
                         "[sample_multiplier] [--device cpu]")
    log_path = argv[0]
    ckpt_idx = int(argv[1]) if len(argv) > 1 else None
    mult = float(argv[2]) if len(argv) > 2 else 1.0
    run(log_path, ckpt_idx, mult, device=device)


if __name__ == "__main__":
    main()

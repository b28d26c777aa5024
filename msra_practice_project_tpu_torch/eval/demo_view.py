"""Novel-view comparison strip: 1 train + 2 val-in + 2 val-ex views rendered
over their ground truth (port of
``msra_practice_project_tpu/eval/demo_view.py``; ref: nerf/demo_view.py:
73-102).

Run: python -m msra_practice_project_tpu_torch.eval.demo_view <log_dir>
     [ckpt] [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core import image_io
from ..train.train_nerf import load_dataset
from .nerf_common import (generator_for, load_experiment, render_view,
                          split_device_flag)


def run(log_path: str, ckpt_idx=None, device=None):
    config, models, _, _ = load_experiment(log_path, ckpt_idx, device)
    images, poses, width, height, focal, _ = load_dataset(config)

    picks = [("train", 0)]
    for split in ["in", "ex"]:
        n = len(images["val"][split])
        for j in range(min(2, n)):
            picks.append((split, j))

    generator = generator_for(models)
    cols = []
    for split, j in picks:
        pose = (poses["train"][j] if split == "train"
                else poses["val"][split][j])
        target = (images["train"][j] if split == "train"
                  else images["val"][split][j])
        rgb, _, _ = render_view(config, models, width, height, focal, pose,
                                generator)
        cols.append(np.concatenate([rgb, np.asarray(target[..., :3])],
                                   axis=0))
    out = os.path.join(log_path, "demo.jpg")
    image_io.imwrite(out, np.concatenate(cols, axis=1))
    print(f"demo strip ({len(picks)} views, render over truth) -> {out}")


def main(argv=None):
    argv, device = split_device_flag(
        argv if argv is not None else sys.argv[1:])
    if not argv:
        raise SystemExit("usage: demo_view <log_dir> [ckpt] [--device cpu]")
    run(argv[0], int(argv[1]) if len(argv) > 1 else None, device=device)


if __name__ == "__main__":
    main()

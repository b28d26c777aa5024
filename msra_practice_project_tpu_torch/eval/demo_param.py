"""Side-by-side comparison grid across several experiments (port of
``msra_practice_project_tpu/eval/demo_param.py``; ref: nerf/demo_param.py:
59-103): the same held-out views (val 'in') rendered by every experiment,
one experiment per row, ground truth on the top row.  Views and truth come
from one shared load (the first experiment's config): a reload per
experiment could pick another train subset or other noisy poses and compare
different cameras per row.

Run: python -m msra_practice_project_tpu_torch.eval.demo_param <out.jpg>
     <log_dir1> <log_dir2> ... [ckpt_idx] [--device cpu]
(an integer last argument pins every experiment to that checkpoint;
otherwise each row shows its latest)
"""

from __future__ import annotations

import sys

import numpy as np

from ..core import image_io
from ..train.train_nerf import load_dataset
from .nerf_common import (generator_for, load_experiment, render_view,
                          split_device_flag)


def run(out_path: str, log_paths: list[str], n_views: int = 3,
        ckpt_idx: int | None = None, device=None):
    cfg0, _, _, _ = load_experiment(log_paths[0], ckpt_idx, device)
    images, poses, width, height, focal, _ = load_dataset(cfg0)
    split = "in" if len(poses["val"]["in"]) else "train"
    view_poses = (poses["val"][split] if split == "in"
                  else poses["train"])[:n_views]
    view_truth = (images["val"][split] if split == "in"
                  else images["train"])[:n_views]

    rows = [np.concatenate([np.asarray(t[..., :3]) for t in view_truth],
                           axis=1)]
    for e, log_path in enumerate(log_paths):
        config, models, _, step = load_experiment(log_path, ckpt_idx,
                                                  device)
        generator = generator_for(models, e)
        row = [render_view(config, models, width, height, focal, pose,
                           generator)[0] for pose in view_poses]
        rows.append(np.concatenate(row, axis=1))
        print(f"[demo_param] {log_path} @ step {step}")
    grid = np.concatenate(rows, axis=0)
    image_io.imwrite(out_path, grid)
    print(f"param comparison grid ({len(log_paths)} experiments, "
          f"{split} views) -> {out_path}")


def main(argv=None):
    argv, device = split_device_flag(
        argv if argv is not None else sys.argv[1:])
    if len(argv) < 2:
        raise SystemExit("usage: demo_param <out.jpg> <log_dir> "
                         "[log_dir...] [ckpt_idx] [--device cpu]")
    ckpt_idx = None
    if len(argv) > 2 and argv[-1].isdigit():
        ckpt_idx = int(argv[-1])
        argv = argv[:-1]
    run(argv[0], argv[1:], ckpt_idx=ckpt_idx, device=device)


if __name__ == "__main__":
    main()

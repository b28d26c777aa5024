"""360-degree orbit GIFs of a trained NeRF, rgb and alpha (port of
``msra_practice_project_tpu/eval/show_nerf.py``): 40 frames over theta in
[-180, 180) at phi = -30, radius 4.

Run: python -m msra_practice_project_tpu_torch.eval.show_nerf <log_dir>
     [ckpt] [W] [H] [focal] [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core import image_io
from ..ops import rays as ray_ops
from ..ops.render import render_video
from .nerf_common import (generator_for, load_experiment, model_fns,
                          split_device_flag)


def run(log_path: str, ckpt_idx=None, width=100, height=100, focal=None,
        n_frames=40, device=None):
    config, models, _, step = load_experiment(log_path, ckpt_idx, device)
    # default: the Blender intrinsic the model was trained with,
    # 0.5*W/tan(0.5*0.6911) = W*1.3875 (ref: nerf/show_nerf.py:17)
    focal = focal or width * 1.3875
    poses = [ray_ops.camera_pose_deg(4.0, float(theta), -30.0)
             for theta in np.linspace(-180, 180, n_frames + 1)[:-1]]
    coarse_fn, fine_fn = model_fns(config, models)
    dev = next(coarse_fn.parameters()).device
    rgbs, _, accs = render_video(
        width, height, focal, poses, config["render_near"],
        config["render_far"], coarse_fn, fine_fn,
        config["render_coarse_sample_num"], config["render_fine_sample_num"],
        generator=generator_for(models), device=dev)
    image_io.mimwrite(os.path.join(log_path, f"show_{step:06d}_rgb.gif"),
                      [image_io.to8b(f) for f in rgbs])
    image_io.mimwrite(os.path.join(log_path, f"show_{step:06d}_alpha.gif"),
                      [image_io.to8b(np.repeat(a, 3, axis=-1)) for a in accs])
    print(f"orbit gifs -> {log_path}/show_{step:06d}_{{rgb,alpha}}.gif")


def main(argv=None):
    argv, device = split_device_flag(
        argv if argv is not None else sys.argv[1:])
    if not argv:
        raise SystemExit("usage: show_nerf <log_dir> [ckpt] [W] [H] [focal] "
                         "[--device cpu]")
    run(argv[0],
        int(argv[1]) if len(argv) > 1 else None,
        int(argv[2]) if len(argv) > 2 else 100,
        int(argv[3]) if len(argv) > 3 else 100,
        float(argv[4]) if len(argv) > 4 else None, device=device)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""End-to-end NeRF quality gate on an analytic scene, for the PyTorch/CUDA
port (the counterpart of tools/validate_nerf.py).

The lego images are not in the repo, so this tool renders a ground-truth
multi-view dataset from an ANALYTIC density field (three coloured soft
spheres; ``--scene=hard``: a view-dependent, high-frequency shell around an
occluded core) with the port's own renderer, writes it in Blender format,
trains a NeRF on it through ``train_nerf.train`` (on CUDA: K1 and K2, the
fused bf16 kernels), and scores train views and held-out test views
(PSNR/SSIM) with the plain models.  The gate: test PSNR > 28 dB (exit code
1 otherwise).

The GT's stratified jitter comes from torch generators seeded per view, so
the images are the port's own, not bit-equal to the JAX tool's; the poses
are the same draws.

Run: python3 tools/torch_validate_nerf.py [iterations] [resolution]
         [--scene=easy|hard] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from msra_practice_project_tpu_torch import resolve_device  # noqa: E402
from msra_practice_project_tpu_torch.core import metrics  # noqa: E402
from msra_practice_project_tpu_torch.core.config import (  # noqa: E402
    NERF_TRAIN_DEFAULTS, resolve)
from msra_practice_project_tpu_torch.data.blender import (  # noqa: E402
    load_blender_data, premultiply_white)
from msra_practice_project_tpu_torch.eval.nerf_common import (  # noqa: E402
    generator_for, load_experiment, render_view)
from msra_practice_project_tpu_torch.ops import rays as ray_ops  # noqa: E402
from msra_practice_project_tpu_torch.ops.render import (  # noqa: E402
    render_image)
from msra_practice_project_tpu_torch.train import train_nerf  # noqa: E402

SPHERES = [  # (center, radius, rgb)
    ((0.0, 0.0, 0.0), 0.6, (0.9, 0.2, 0.2)),
    ((0.8, 0.0, 0.3), 0.35, (0.2, 0.8, 0.3)),
    ((-0.6, 0.5, -0.3), 0.45, (0.2, 0.3, 0.9)),
]
PASS_DB = 28.0


def analytic_field_hard(x):
    """f([..., 6]) -> [..., 4]: the HARD scene.

      * view-dependent emission: a facing term against the radial normal and
        a view tint (exercises the direction branch);
      * high-frequency structure: a trig checker at ~12 rad/unit over a thin
        shell (exercises the high PE frequencies);
      * a thin shell around an occluded core (exercises hierarchical
        sampling: most of [near, far] is empty).
    """
    pos, dirs = x[..., :3], x[..., 3:6]
    d = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-9)
    r = torch.linalg.norm(pos, dim=-1)

    s_shell = 55.0 * torch.sigmoid((0.07 - torch.abs(r - 0.9)) * 120.0)
    s_core = 65.0 * torch.sigmoid((0.38 - r) * 45.0)
    sigma = torch.maximum(s_shell, s_core)

    # high-frequency checker on the shell
    ch = (torch.sin(12.0 * pos[..., 0]) * torch.sin(12.0 * pos[..., 1])
          * torch.sin(12.0 * pos[..., 2]))
    checker = torch.sigmoid(8.0 * ch)[..., None]  # ~binary 0/1 pattern
    col_a = x.new_tensor([0.95, 0.25, 0.15])
    col_b = x.new_tensor([0.95, 0.85, 0.2])
    base_shell = checker * col_a + (1 - checker) * col_b
    base_core = x.new_tensor([0.2, 0.4, 0.95]) * torch.ones_like(base_shell)
    w_shell = (s_shell / (s_shell + s_core + 1e-6))[..., None]
    base = w_shell * base_shell + (1 - w_shell) * base_core

    # view dependence: facing term against the radial normal + a view tint
    n = pos / (r[..., None] + 1e-9)
    cosv = torch.clip(-torch.sum(d * n, dim=-1), 0.0, 1.0)[..., None]
    tint = 0.5 + 0.5 * d
    kv = 0.35 * cosv
    rgb = torch.clip((0.55 + 0.45 * cosv) * base * (1 - kv) + kv * tint,
                     0.0, 1.0)
    return torch.cat([rgb, sigma[..., None]], dim=-1)


def analytic_field(x):
    """f([..., 6]) -> [..., 4]: soft coloured spheres (view-independent)."""
    pos = x[..., :3]
    sigma = pos.new_zeros(pos.shape[:-1])
    rgb_acc = pos.new_zeros((*pos.shape[:-1], 3))
    w_acc = pos.new_zeros(pos.shape[:-1])
    for (c, r, col) in SPHERES:
        d = torch.linalg.norm(pos - pos.new_tensor(c), dim=-1)
        s = 60.0 * torch.sigmoid((r - d) * 40.0)
        sigma = torch.maximum(sigma, s)
        w = s + 1e-6
        rgb_acc = rgb_acc + w[..., None] * pos.new_tensor(col)
        w_acc = w_acc + w
    rgb = rgb_acc / w_acc[..., None]
    return torch.cat([rgb, sigma[..., None]], dim=-1)


SCENES = {"easy": analytic_field, "hard": analytic_field_hard}
_SPLIT_ID = {"train": 0, "val": 1, "test": 2}


def view_seed(seed: int, split: str, i: int) -> int:
    """The seed of view ``i`` of ``split``'s GT jitter generator."""
    return (seed * 3 + _SPLIT_ID[split]) * 1_000_003 + i


def make_dataset(out_dir: str, size: int, n_train=30, n_val=5, n_test=5,
                 seed=0, scene="easy", device=None):
    """Render the scene at ``size``^2 from random orbit poses (radius 4,
    theta in [-180, 180), phi in [-60, -5), drawn as the JAX tool draws
    them) and write it in Blender format.  Returns the focal length."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    focal = 0.5 * size / np.tan(0.5 * 0.6911112)
    os.makedirs(out_dir, exist_ok=True)
    for split, n in [("train", n_train), ("val", n_val), ("test", n_test)]:
        frames = []
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        for i, (theta, phi) in enumerate(
                zip(rng.uniform(-180, 180, n), rng.uniform(-60, -5, n))):
            c2w = ray_ops.camera_pose_deg(4.0, float(theta),
                                          float(phi)).numpy()
            # GT rendered WITHOUT the white background and stored as
            # straight-alpha RGBA: the Blender loader composites
            # rgb*a + (1-a), so storing an already white-composited rgb
            # would composite twice (biasing every 0<acc<1 pixel to white).
            gen = torch.Generator(device=device).manual_seed(
                view_seed(seed, split, i))
            rgb_pm, _, acc = render_image(
                size, size, focal, c2w, 2.0, 6.0, SCENES[scene],
                SCENES[scene], 64, 128, white_bkgd=False, generator=gen,
                device=device)
            rgb_pm, acc = rgb_pm.cpu().numpy(), acc.cpu().numpy()
            straight = rgb_pm / np.maximum(acc, 1e-6)
            rgba = np.concatenate([straight, acc], axis=-1)
            img8 = (np.clip(rgba, 0, 1) * 255).astype(np.uint8)
            rel = f"./{split}/r_{i}"
            Image.fromarray(img8, "RGBA").save(
                os.path.join(out_dir, rel + ".png"))
            m = np.linalg.inv(ray_ops.BLENDER_COORD) @ c2w
            frames.append({"file_path": rel, "transform_matrix": m.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"),
                  "w") as fp:
            json.dump({"camera_angle_x": 0.6911112, "frames": frames}, fp)
    return focal


def main(iterations=3000, size=64, scene="easy", device=None, out_dir=None,
         use_siren=False, overrides=None):
    """Render the dataset (once per scene and size under ``out_dir``), train
    afresh, and score 5 train views and the test views.  ``overrides``
    replaces keys of the training config (smaller runs).  Returns {"train":
    (psnr, ssim), "test": (psnr, ssim), "log_path", "steps", "ms_per_step",
    "psnr_curve"}; ms_per_step is the train steps' own window (CUDA events
    on the card, the host clock on the CPU)."""
    if use_siren:
        raise NotImplementedError(
            "--siren needs the SIREN NeRF, which the port does not have yet "
            "(ROADMAP.md section 1, item 3)")
    device = resolve_device(device)
    base = out_dir or os.path.join(tempfile.gettempdir(),
                                   "nerf_validate_torch")
    # the cache key holds the resolution: a dataset at another size would
    # silently override the argument
    data_dir = os.path.join(base, f"data_{scene}_{size}")
    if not os.path.exists(os.path.join(data_dir, "transforms_train.json")):
        print(f"[validate] rendering analytic dataset ({scene}, {size}^2)...",
              flush=True)
        make_dataset(data_dir, size, scene=scene, device=device)

    exp = f"exp_{scene}"
    cfg = resolve({
        "output_path": base, "experiment_name": exp,
        "data_path": data_dir, "data_resize": 1.0, "data_skip": 1,
        "iterations": iterations, "batch_size": 1024, "start_up_itrs": 200,
        "i_print": max(iterations // 10, 1), "i_save": iterations,
        "i_image": iterations, "steps_per_call": 10, **(overrides or {}),
    }, NERF_TRAIN_DEFAULTS)
    # a fresh run every time: a checkpoint at `iterations` would resume into
    # a 0-step no-op and validate the previous run
    log_path = os.path.join(base, exp)
    shutil.rmtree(log_path, ignore_errors=True)
    print(f"[validate] training {iterations} iters...", flush=True)
    out = train_nerf.train(cfg, device=device, timed_steps=iterations)
    psnr_curve = [float(v) for v in out["log"]["psnr"]]

    # held-out evaluation against the analytic ground truth
    config, models, _, _ = load_experiment(log_path, device=device)
    images, poses, width, height, focal, _ = load_blender_data(
        data_dir, 1.0, 1)
    premultiply_white(images)
    generator = generator_for(models, 7)
    results = {}
    for split, (imgs, ps) in [
        ("train", (images["train"][:5], poses["train"][:5])),
        ("test", (images["test"], poses["test"])),
    ]:
        psnrs, ssims = [], []
        for img, pose in zip(imgs, ps):
            rgb, _, _ = render_view(config, models, width, height, focal,
                                    pose, generator)
            target = img[..., :3]
            psnrs.append(metrics.psnr(rgb, target))
            ssims.append(metrics.ssim(rgb, target))
        results[split] = (float(np.mean(psnrs)), float(np.mean(ssims)))
        print(f"[validate] {split}: PSNR {results[split][0]:.2f} dB  "
              f"SSIM {results[split][1]:.4f}", flush=True)

    print(f"[validate] train-batch psnr curve: start "
          f"{np.mean(psnr_curve[:50]):.1f} -> end "
          f"{np.mean(psnr_curve[-50:]):.1f}")
    ok = results["test"][0] > PASS_DB
    print("[validate]", "PASS" if ok else "FAIL",
          f"(novel-view PSNR {'>' if ok else '<='} {PASS_DB:g} dB)",
          flush=True)
    return {**results, "log_path": log_path, "steps": iterations,
            "ms_per_step": out["window_ms"] / iterations,
            "psnr_curve": psnr_curve}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("iterations", nargs="?", type=int, default=3000)
    p.add_argument("size", nargs="?", type=int, default=64)
    p.add_argument("--scene", choices=sorted(SCENES), default="easy")
    p.add_argument("--siren", action="store_true",
                   help="the SIREN NeRF (not ported yet: raises)")
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: CUDA)")
    p.add_argument("--out", default=None,
                   help="directory for the dataset and the experiment "
                        "(default: <tmp>/nerf_validate_torch)")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args(sys.argv[1:])
    res = main(a.iterations, a.size, a.scene, a.device, a.out, a.siren)
    sys.exit(0 if res["test"][0] > PASS_DB else 1)

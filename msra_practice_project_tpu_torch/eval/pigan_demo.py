"""pi-GAN demo suite: the reference's six demo modes (port of
``msra_practice_project_tpu/eval/pigan_demo.py``; ref: pi_GAN/demo.py:48-69,
pi_GAN/utils.py:183-295).

  0  save_demo          8x8 random-sample grid
  1  multiview          rows of identities across a circle of yaw poses
  2  yaw extrapolation  wider yaw range than the training pose prior
  3  fov sweep          6..30 degree field of view
  4  orbit GIF          one identity, yaw orbit video
  5  interpolation      z-space vs w(film)-space interpolation rows
  6  style mixing       film-code crossover at each of the 9 FiLM layers

The reference's demo.py:31-33 sets ``render_coarse_sample_num`` twice and
never ``render_fine_sample_num``; the modes render with the intended coarse
32 / fine 64 at 128^2 (mode 0's grid at 64^2).

Latents, poses and jitter come from torch generators seeded per call;
``z`` or ``film`` arguments inject them.  On CUDA the trunk runs K8 (in
fp32 in the default mode 1).

Run: python -m msra_practice_project_tpu_torch.eval.pigan_demo <config.json>
         <mode> [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import resolve_device, set_plain_precision, weights
from ..core import ckpt as ckpt_lib
from ..core import diagnostics, image_io
from ..core.config import PIGAN_TRAIN_DEFAULTS, log_dir
from ..models import pigan
from ..train import common
from .nerf_common import split_device_flag

DEMO_RES = 128
GRID_RES = 64          # mode 0's grid (save_demo's default resolution)
DEMO_COARSE, DEMO_FINE = 32, 64
DEMO_SEED = 42


def resolve_saved(config):
    """Prefer the train-resolved config.json written into the experiment
    directory: train-time ``key=value`` overrides (render_far=...,
    use_dir=...) would otherwise be lost at eval."""
    saved = os.path.join(log_dir(config), "config.json")
    if os.path.exists(saved):
        return common.parse_cli([saved], PIGAN_TRAIN_DEFAULTS)
    return config


def _eval_watchdog(config):
    """Arm the experiment's watchdog for long demo renders, with a 900 s
    floor (the first render pays the kernels' first use)."""
    t = float(config.get("watchdog_timeout", 0.0) or 0.0)
    return diagnostics.Watchdog(max(t, 900.0) if t > 0 else 0.0,
                                log_dir(config))


# Point-sample budget of one render call: a whole-batch render of a demo grid
# would hold B x rays x samples x 256 activations at once, so demos render
# the identities in chunks of the largest size that fits.
_POINT_BUDGET = 2_000_000


def _chunk_size(resolution, coarse, fine):
    pts = resolution * resolution * (2 * coarse + fine)
    return max(1, _POINT_BUDGET // max(pts, 1))


def _device(gen_model):
    return next(gen_model.parameters()).device


def _gen(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


@torch.no_grad()
def _render_chunked(gen_model, film, theta, phi, resolution, coarse, fine,
                    fov=None, *, generator=None, beat=None):
    """``render_film`` over chunks of identities -> ``[B, H, W, 3]`` numpy."""
    c = _chunk_size(resolution, coarse, fine)
    outs = []
    for lo in range(0, film.shape[0], c):
        if beat is not None:
            beat(f"render chunk {lo}/{film.shape[0]}")
        outs.append(gen_model.render_film(
            film[lo:lo + c], theta[lo:lo + c], phi[lo:lo + c], resolution,
            coarse, fine, fov, generator=generator).cpu().numpy())
    return np.concatenate(outs, axis=0)


def render_films(gen_model, film, poses, resolution=DEMO_RES,
                 coarse=DEMO_COARSE, fine=DEMO_FINE, fov=None, *,
                 generator=None, beat=None):
    """film ``[B, 9, 512]`` x poses ``[(theta, phi[, fov]), ...]`` ->
    ``[B, P, H, W, 3]`` numpy; a pose's third element is its fov.  ``beat``
    (optional callable) is invoked per pose: watchdog liveness for long
    orbit renders."""
    out = []
    for i, pose in enumerate(poses):
        if beat is not None:
            beat(f"render pose {i}/{len(poses)}")
        theta = torch.full((film.shape[0],), float(pose[0]),
                           device=film.device)
        phi = torch.full((film.shape[0],), float(pose[1]),
                         device=film.device)
        f = float(pose[2]) if len(pose) >= 3 else fov
        out.append(_render_chunked(gen_model, film, theta, phi, resolution,
                                   coarse, fine, f, generator=generator,
                                   beat=beat))
    return np.stack(out, axis=1)


def _grid(imgs_2d):
    """``[R, C, H, W, 3]`` -> one image."""
    rows = [np.concatenate(list(r), axis=1) for r in imgs_2d]
    return np.concatenate(rows, axis=0)


@torch.no_grad()
def save_demo(gen_model, file_name, rows=8, columns=8, resolution=GRID_RES,
              coarse=DEMO_COARSE, fine=DEMO_FINE, *, generator=None,
              beat=None):
    """Random-sample grid at random prior poses (ref: pi_GAN/utils.py:
    185-204); latents, poses and jitter come from ``generator``."""
    num = rows * columns
    dev = _device(gen_model)
    z = torch.randn(num, gen_model.cfg.z_dim, generator=generator,
                    device=dev)
    film = gen_model.get_mapping(z)
    theta, phi = gen_model.sample_poses(num, generator, dev)
    imgs = _render_chunked(gen_model, film, theta, phi, resolution, coarse,
                           fine, generator=generator, beat=beat)
    image_io.imwrite(file_name, _grid(imgs.reshape(rows, columns,
                                                   *imgs.shape[1:])))


@torch.no_grad()
def _films_of(gen_model, n, generator, z=None):
    """Film codes of ``z`` (``[n, z_dim]``), drawn from ``generator`` when
    not given."""
    if z is None:
        z = torch.randn(n, gen_model.cfg.z_dim, generator=generator,
                        device=_device(gen_model))
    return gen_model.get_mapping(z)


def demo_multiview(gen_model, file_name, poses, rows=4, film=None,
                   resolution=DEMO_RES, coarse=DEMO_COARSE, fine=DEMO_FINE,
                   *, seed=DEMO_SEED, beat=None):
    """Rows of identities (``film`` or ``rows`` random ones) across poses."""
    gen = _gen(seed, _device(gen_model))
    if film is None:
        film = _films_of(gen_model, rows, gen)
    imgs = render_films(gen_model, film, poses, resolution, coarse, fine,
                        generator=gen, beat=beat)
    image_io.imwrite(file_name, _grid(imgs))


def demo_video(gen_model, file_name, poses, film=None, resolution=DEMO_RES,
               coarse=DEMO_COARSE, fine=DEMO_FINE, *, seed=DEMO_SEED,
               beat=None):
    """Orbit GIF of one identity (ref: pi_GAN/utils.py:231-243)."""
    gen = _gen(seed, _device(gen_model))
    if film is None:
        film = _films_of(gen_model, 1, gen)
    imgs = render_films(gen_model, film, poses, resolution, coarse, fine,
                        generator=gen, beat=beat)[0]
    image_io.mimwrite(file_name, [image_io.to8b(f) for f in imgs],
                      duration=0.1)


@torch.no_grad()
def interpolation_films(gen_model, z2, cols):
    """z-space and film(w)-space interpolation between two latents ``z2``
    ``[2, z_dim]``: (film_z, film_w), each ``[cols, 9, 512]``."""
    k = torch.linspace(0.0, 1.0, cols, device=z2.device)
    z = z2[0][None] * (1 - k[:, None]) + z2[1][None] * k[:, None]
    film_z = gen_model.get_mapping(z)
    f2 = gen_model.get_mapping(z2)
    film_w = f2[0][None] * (1 - k[:, None, None]) + \
        f2[1][None] * k[:, None, None]
    return film_z, film_w


def demo_interpolate(gen_model, file_name, cols, pose=(0.0, 0.0),
                     resolution=DEMO_RES, coarse=DEMO_COARSE, fine=DEMO_FINE,
                     *, z=None, seed=DEMO_SEED, beat=None):
    """z-space (top row) vs film/w-space (bottom row) interpolation between
    two latents (``z`` ``[2, z_dim]``, or drawn) (ref: pi_GAN/utils.py:
    246-272).  Both rows render with one jitter stream."""
    dev = _device(gen_model)
    if z is None:
        z = torch.randn(2, gen_model.cfg.z_dim, generator=_gen(seed, dev),
                        device=dev)
    film_z, film_w = interpolation_films(gen_model, z, cols)
    rows = [render_films(gen_model, f, [pose], resolution, coarse, fine,
                         generator=_gen(seed + 1, dev), beat=beat)[:, 0]
            for f in (film_z, film_w)]
    image_io.imwrite(file_name, _grid(np.stack(rows)))


def style_mix_films(film, i):
    """Crossover of identities 2i and 2i+1 at layer cut 9..0: ``[10, 9,
    512]``, row k taking its first 9-k layers from identity 2i."""
    return torch.stack([torch.cat([film[2 * i][:cut], film[2 * i + 1][cut:]])
                        for cut in range(9, -1, -1)])


def demo_style_mix(gen_model, file_name, rows, pose=(0.0, 0.0),
                   resolution=DEMO_RES, coarse=DEMO_COARSE, fine=DEMO_FINE,
                   *, z=None, seed=DEMO_SEED, beat=None):
    """Film-code crossover at layer k for k = 9..0, one row per pair of
    latents (``z`` ``[2*rows, z_dim]``, or drawn) (ref: pi_GAN/utils.py:
    275-295)."""
    dev = _device(gen_model)
    film = _films_of(gen_model, 2 * rows, _gen(seed, dev), z)
    grid_rows = [render_films(gen_model, style_mix_films(film, i), [pose],
                              resolution, coarse, fine,
                              generator=_gen(seed + i + 1, dev),
                              beat=beat)[:, 0]
                 for i in range(rows)]
    image_io.imwrite(file_name, _grid(np.stack(grid_rows)))


def load_generator(config, device=None):
    """Rebuild G and D from the experiment's newest checkpoint
    (``{"g": state_dict, "d": state_dict, ...}``, as train_pigan writes
    it, or a JAX run's), frozen for inference: (generator, discriminator,
    step).  Warns and keeps a fresh init when there is no checkpoint.  Sets
    the plain fp32 precision the trainer runs D at
    (``set_plain_precision``)."""
    device = resolve_device(device)
    set_plain_precision()
    gen_cfg = pigan.GeneratorConfig(
        z_dim=config["z_dim"], resolution=64,
        near=config["render_near"], far=config["render_far"], fov=12.0,
        coarse_samples=config["render_coarse_sample_num"],
        fine_samples=config["render_fine_sample_num"],
        horizontal_std=0.45, vertical_std=0.15, use_dir=config["use_dir"])
    init = torch.Generator().manual_seed(0)
    generator = pigan.Generator(gen_cfg, generator=init).to(device)
    discriminator = pigan.Discriminator(generator=init).to(device)
    log_path = log_dir(config)
    found = ckpt_lib.restore_latest(log_path, map_location=device)
    if found is None:
        print(f"[warn] no checkpoint under {log_path}; using fresh init")
        step = 0
    else:
        step, saved = found
        saved = weights.restore_state(saved, "pigan")
        generator.load_state_dict(saved["g"])
        discriminator.load_state_dict(saved["d"])
    generator.requires_grad_(False)
    discriminator.requires_grad_(False)
    return generator, discriminator, step


def run(config, mode: int, device=None) -> str:
    """Write demo ``mode``'s file into the experiment directory; returns
    its path."""
    config = resolve_saved(config)
    generator, _, step = load_generator(config, device)
    log_path = log_dir(config)
    os.makedirs(log_path, exist_ok=True)  # the fresh-init path has no dir
    watchdog = _eval_watchdog(config)
    beat = watchdog.beat
    out = os.path.join(log_path, f"demo_{mode}")
    size = dict(resolution=DEMO_RES, coarse=DEMO_COARSE, fine=DEMO_FINE)

    n_pose = 9
    if mode == 0:
        out += ".png"
        save_demo(generator, out, resolution=GRID_RES, coarse=DEMO_COARSE,
                  fine=DEMO_FINE, generator=_gen(DEMO_SEED, _device(
                      generator)), beat=beat)
    elif mode in (1, 2, 3):
        if mode == 1:
            poses = [(0.15 * (i - (n_pose - 1) / 2), 0.0)
                     for i in range(n_pose)]
        elif mode == 2:  # yaw extrapolation
            poses = [(0.3 * (i - (n_pose - 1) / 2), 0.0)
                     for i in range(n_pose)]
        else:            # fov sweep
            poses = [(0.0, 0.0, fov) for fov in np.linspace(6, 30, n_pose)]
        out += ".png"
        demo_multiview(generator, out, poses, **size, beat=beat)
    elif mode == 4:      # orbit gif
        out += ".gif"
        poses = [(a, 0.0) for a in np.linspace(-1, 1, 41)[:-1]]
        demo_video(generator, out, poses, **size, beat=beat)
    elif mode == 5:
        out += ".png"
        demo_interpolate(generator, out, cols=8, **size, beat=beat)
    elif mode == 6:
        out += ".png"
        demo_style_mix(generator, out, rows=4, **size, beat=beat)
    else:
        watchdog.stop()
        raise SystemExit(f"unknown demo mode {mode}")
    watchdog.stop()
    print(f"demo mode {mode} (ckpt step {step}) -> {out}")
    return out


def main(argv=None):
    argv, device = split_device_flag(argv if argv is not None
                                     else sys.argv[1:])
    config = common.parse_cli(argv[:1], PIGAN_TRAIN_DEFAULTS)
    mode = int(argv[1]) if len(argv) > 1 else 0
    return run(config, mode, device)


def show_pose_distribution(gen_model, n=1000, save_path=None, *,
                           generator=None):
    """Scatter of the camera-pose prior theta ~ N(0, h_std), phi ~ N(0,
    v_std) (ref: pi_GAN/modules.py:148-152 Renderer.show_distribution)."""
    import matplotlib
    if save_path is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    theta, phi = gen_model.sample_poses(n, generator)
    plt.figure(figsize=(4, 4))
    plt.scatter(theta.cpu().numpy(), phi.cpu().numpy(), s=3)
    plt.xlabel("theta (rad)")
    plt.ylabel("phi (rad)")
    plt.tight_layout()
    if save_path is not None:
        plt.savefig(save_path, dpi=150)
        plt.close()
    else:
        plt.show()


if __name__ == "__main__":
    main()

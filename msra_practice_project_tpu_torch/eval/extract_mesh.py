"""Extract a mesh from a trained pi-GAN generator's density field (port of
``msra_practice_project_tpu/eval/extract_mesh.py``).

Ref: pi_GAN/extract_mesh.py + pi_GAN/utils.py:42-106: sample one identity's
film code, evaluate sigma on an N^3 grid over the +-0.1 cube, negate it
(pseudo-SDF), and march at level -20.  One x-slice per trunk call (x ``[1,
N^2, 6]``, film ``[1, 9, 512]``): on CUDA each slice is one K8 launch (in
fp32 in the default mode 1).

Run: python -m msra_practice_project_tpu_torch.eval.extract_mesh
         <config.json> [N] [level] [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..core import mesh as mesh_lib
from ..core.config import PIGAN_TRAIN_DEFAULTS, log_dir
from ..train import common
from .nerf_common import split_device_flag
from .pigan_demo import _eval_watchdog, load_generator, resolve_saved

BOUND = 0.1      # voxel_origin = [-0.1]*3, cube edge 0.2 (pi_GAN/utils.py:56-57)
LEVEL = -20.0    # marching level on -sigma (pi_GAN/utils.py:135-137)
MESH_SEED = 7


def slice_points(x_coord, n: int, device=None) -> torch.Tensor:
    """The trunk's input for the grid's slice at ``x_coord``: ``[1, n*n,
    6]``, positions (x, y, z) with y, z on the grid, directions zero."""
    grid = torch.linspace(-BOUND, BOUND, n, device=device)
    yy, zz = torch.meshgrid(grid, grid, indexing="ij")
    pos = torch.stack([torch.full_like(yy, float(x_coord)), yy, zz], dim=-1)
    return torch.cat([pos, torch.zeros_like(pos)], dim=-1).reshape(1, -1, 6)


@torch.no_grad()
def sigma_slice(trunk, film, x_coord, n: int) -> torch.Tensor:
    """Negated sigma (pseudo-SDF) on one x-slice: ``[n, n]``."""
    raw = trunk(slice_points(x_coord, n, film.device), film, need_dx=False)
    return -raw[0, :, 3].reshape(n, n)


@torch.no_grad()
def sigma_grid(gen_model, film, n: int, watchdog=None) -> np.ndarray:
    """``-sigma`` on the n^3 grid, ``[n, n, n]`` float32, one slice per
    trunk call."""
    xs = np.linspace(-BOUND, BOUND, n).astype(np.float32)
    values = np.empty((n, n, n), np.float32)
    for i, x in enumerate(xs):
        if watchdog is not None:
            watchdog.beat(f"sigma slice {i}/{n}")
        values[i] = sigma_slice(gen_model.trunk, film, x, n).cpu().numpy()
    return values


def march(values, filename: str, level: float = LEVEL, watchdog=None):
    """Vertices and faces of the ``level`` isosurface of ``values``
    (written to ``filename.ply``), with the empty-isosurface message."""
    n = values.shape[0]
    voxel_size = 2 * BOUND / (n - 1)
    if watchdog is not None:
        # host-side marching can legitimately exceed the heartbeat
        watchdog.pause()
    try:
        verts, faces = mesh_lib.extract_mesh_from_grid(
            values, level, (-BOUND,) * 3, voxel_size, filename + ".ply")
    finally:
        if watchdog is not None:
            watchdog.resume()
    if verts.shape[0] == 0:
        # values holds -sigma; an isosurface at level -20 needs sigma to
        # cross 20 inside the +-BOUND cube (true for the reference's fully
        # trained face models, not for short runs with diffuse fields)
        print(f"[extract_mesh] empty isosurface: sigma in "
              f"[{-values.max():.2f}, {-values.min():.2f}] never crosses "
              f"{-level:.0f} inside the +-{BOUND} cube (under-trained "
              f"generator?)")
    return verts, faces


def extract_mesh(gen_model, filename: str, n: int = 256,
                 level: float = LEVEL, watchdog=None, *, z=None):
    """One identity's (``z`` ``[1, z_dim]``, or drawn) mesh: (verts, faces,
    the ``-sigma`` grid)."""
    dev = next(gen_model.parameters()).device
    if z is None:
        z = torch.randn(1, gen_model.cfg.z_dim, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            MESH_SEED))
    with torch.no_grad():
        film = gen_model.get_mapping(z)
    values = sigma_grid(gen_model, film, n, watchdog)
    verts, faces = march(values, filename, level, watchdog)
    return verts, faces, values


def main(argv=None):
    argv, device = split_device_flag(argv if argv is not None
                                     else sys.argv[1:])
    config = resolve_saved(common.parse_cli(argv[:1], PIGAN_TRAIN_DEFAULTS))
    n = int(argv[1]) if len(argv) > 1 else 256
    # optional marching level (on -sigma): the reference hardcodes -20,
    # calibrated for fully converged face models; softer fields need a
    # level inside their sigma range (the empty-isosurface message prints it)
    level = float(argv[2]) if len(argv) > 2 else LEVEL
    generator, _, step = load_generator(config, device)
    os.makedirs(log_dir(config), exist_ok=True)
    out = os.path.join(log_dir(config), f"mesh_{step:06d}")
    watchdog = _eval_watchdog(config)
    verts, faces, _ = extract_mesh(generator, out, n=n, level=level,
                                   watchdog=watchdog)
    watchdog.stop()
    print(f"mesh: {verts.shape[0]} verts, {faces.shape[0]} faces -> "
          f"{out}.ply")
    return verts, faces


if __name__ == "__main__":
    main()

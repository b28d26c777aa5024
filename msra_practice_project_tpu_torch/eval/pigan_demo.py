"""pi-GAN demo renders (port of part of
``msra_practice_project_tpu/eval/pigan_demo.py``): the random-sample grid
that training writes every ``i_image`` iterations (ref: pi_GAN/utils.py:
185-204).  The demo modes (multiview, yaw extrapolation, fov sweep, orbit,
interpolation, style mixing) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import image_io

DEMO_COARSE, DEMO_FINE = 32, 64

# Point-sample budget of one render call: a whole-batch render of a demo grid
# would hold B x rays x samples x 256 activations at once, so demos render
# the identities in chunks of the largest size that fits.
_POINT_BUDGET = 2_000_000


def _chunk_size(resolution, coarse, fine):
    pts = resolution * resolution * (2 * coarse + fine)
    return max(1, _POINT_BUDGET // max(pts, 1))


@torch.no_grad()
def _render_chunked(gen_model, film, theta, phi, resolution, coarse, fine,
                    *, generator=None):
    """``render_film`` over chunks of identities -> ``[B, H, W, 3]`` numpy."""
    c = _chunk_size(resolution, coarse, fine)
    outs = []
    for lo in range(0, film.shape[0], c):
        outs.append(gen_model.render_film(
            film[lo:lo + c], theta[lo:lo + c], phi[lo:lo + c], resolution,
            coarse, fine, generator=generator).cpu().numpy())
    return np.concatenate(outs, axis=0)


def _grid(imgs_2d):
    """``[R, C, H, W, 3]`` -> one image."""
    rows = [np.concatenate(list(r), axis=1) for r in imgs_2d]
    return np.concatenate(rows, axis=0)


@torch.no_grad()
def save_demo(gen_model, file_name, rows=8, columns=8, resolution=64,
              coarse=DEMO_COARSE, fine=DEMO_FINE, *, generator=None):
    """Random-sample grid at random prior poses (ref: pi_GAN/utils.py:
    185-204); latents, poses and jitter come from ``generator``."""
    num = rows * columns
    dev = next(gen_model.parameters()).device
    z = torch.randn(num, gen_model.cfg.z_dim, generator=generator,
                    device=dev)
    film = gen_model.get_mapping(z)
    theta, phi = gen_model.sample_poses(num, generator, dev)
    imgs = _render_chunked(gen_model, film, theta, phi, resolution, coarse,
                           fine, generator=generator)
    image_io.imwrite(file_name, _grid(imgs.reshape(rows, columns,
                                                   *imgs.shape[1:])))

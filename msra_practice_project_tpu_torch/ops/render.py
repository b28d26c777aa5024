"""Hierarchical (coarse/fine) volume rendering (port of
``msra_practice_project_tpu/ops/render.py``: ``render_rays``,
``render_image``, ``render_image_sharded`` and ``render_video``).

The model is a function ``model_fn(x[..., 6]) -> [..., 4]``.  Randomness is
explicit: a ``torch.Generator`` draws the stratified jitter, or the caller
hands the jitter in (the parity tests rebuild JAX's draws).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import mesh
from .composite import raw_to_outputs
from .rays import get_rays_flat
from .sampling import sample_pdf, stratified_samples


def render_rays(rays_o, rays_d, near, far, coarse_fn, fine_fn,
                coarse_sample_num: int, fine_sample_num: int,
                perturb: bool = True, white_bkgd: bool = True,
                last_dist_mode: str = "inf", *,
                generator: torch.Generator | None = None,
                jitter: torch.Tensor | None = None):
    """Render a batch of rays (ref: nerf/render.py:106-147).

    rays_o/rays_d: ``[..., R, 3]``.  Returns a dict with the coarse and fine
    rgb/depth/acc maps (``[..., R, 3]`` / ``[..., R]``).  ``jitter``
    (``[..., R, coarse_sample_num]``) replaces the generator's draws.
    """
    view_dirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    batch_shape = rays_o.shape[:-1]

    # Coarse pass: stratified samples.
    z_vals, mids = stratified_samples(
        near, far, coarse_sample_num, batch_shape, perturb,
        generator=generator, jitter=jitter, device=rays_o.device,
        dtype=rays_o.dtype)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    dirs = view_dirs[..., None, :].expand(pts.shape)
    raw = coarse_fn(torch.cat([pts, dirs], dim=-1))
    rgb_c, depth_c, acc_c, weights = raw_to_outputs(
        raw, z_vals, rays_d, white_bkgd, last_dist_mode)

    # Fine pass: importance samples from the coarse weights, merged + sorted.
    z_samples = sample_pdf(mids, weights[..., 1:-1], fine_sample_num)
    z_all, _ = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
    dirs = view_dirs[..., None, :].expand(pts.shape)
    raw = fine_fn(torch.cat([pts, dirs], dim=-1))
    rgb_f, depth_f, acc_f, _ = raw_to_outputs(raw, z_all, rays_d, white_bkgd,
                                              last_dist_mode)

    return {
        "rgb_coarse": rgb_c, "depth_coarse": depth_c, "acc_coarse": acc_c,
        "rgb_fine": rgb_f, "depth_fine": depth_f, "acc_fine": acc_f,
    }


def _pad_to_multiple(x, multiple):
    """Pad rows up to a multiple by repeating the last row (``edge``)."""
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0), n


@torch.no_grad()
def render_image(width, height, focal, c2w, near, far, coarse_fn, fine_fn,
                 coarse_sample_num: int, fine_sample_num: int,
                 chunk: int = 16384, perturb: bool = True,
                 white_bkgd: bool = True, *,
                 generator: torch.Generator | None = None,
                 jitter: torch.Tensor | None = None, device=None):
    """Full-frame render, tiled over fixed-size ray blocks
    (ref: nerf/render.py:150-167).  Returns (rgb ``[H,W,3]``, depth
    ``[H,W,1]``, acc ``[H,W,1]``) tensors on ``device``.  ``jitter``
    (``[H*W, coarse_sample_num]``, pixels in row-major order) replaces the
    generator's stratified draws.

    Under a process group of n ranks (``parallel/mesh.py``) every rank must
    call it: the tiles are split over the ranks as the JAX package's
    ``render_image_sharded`` splits them over its chips.  ``chunk`` is cut
    to at most a rank's share of the rays, the rays are padded to a whole
    number of tiles per rank, each rank renders its contiguous block of
    tiles and the blocks are gathered to every rank
    (``mesh.all_gather_rows``).  Every rank draws every tile's jitter, in
    tile order, and keeps its own, so the image is the one a single process
    renders with the same tiles from the same generator state (exactly so
    with ``perturb=False``)."""
    n_dev = mesh.world()
    chunk = min(chunk, max(1, -(-width * height // n_dev)))
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    rays_o, rays_d = get_rays_flat(width, height, focal, c2w)
    rays_o, n = _pad_to_multiple(rays_o, chunk * n_dev)
    rays_d, _ = _pad_to_multiple(rays_d, chunk * n_dev)
    if jitter is not None:
        jitter, _ = _pad_to_multiple(jitter.to(rays_o.device), chunk * n_dev)
    per_rank = rays_o.shape[0] // (chunk * n_dev)
    first = mesh.rank() * per_rank
    block = []
    for t in range(per_rank * n_dev):
        rows = slice(t * chunk, (t + 1) * chunk)
        if jitter is not None:
            tile_jitter = jitter[rows]
        elif perturb:
            tile_jitter = torch.rand((chunk, coarse_sample_num),
                                     generator=generator, dtype=rays_o.dtype,
                                     device=rays_o.device)
        else:
            tile_jitter = None
        if not first <= t < first + per_rank:
            continue
        out = render_rays(rays_o[rows], rays_d[rows], near, far, coarse_fn,
                          fine_fn, coarse_sample_num, fine_sample_num,
                          perturb, white_bkgd, jitter=tile_jitter)
        block.append(torch.cat([out["rgb_fine"], out["depth_fine"][:, None],
                                out["acc_fine"][:, None]], dim=-1))
    full = mesh.all_gather_rows(torch.cat(block))[:n]
    return (full[:, :3].reshape(height, width, 3),
            full[:, 3:4].reshape(height, width, 1),
            full[:, 4:5].reshape(height, width, 1))


# The JAX package's name for the multi-chip render, which here is
# ``render_image`` itself.
render_image_sharded = render_image


def render_video(width, height, focal, poses, near, far, coarse_fn, fine_fn,
                 coarse_sample_num: int, fine_sample_num: int,
                 chunk: int = 16384, perturb: bool = True, *,
                 generator: torch.Generator | None = None, device=None):
    """Render a pose sequence (ref: nerf/render.py:170-182); ``generator``
    draws every frame's jitter, frame after frame.  Returns stacked numpy
    arrays (rgb ``[F,H,W,3]``, depth and acc ``[F,H,W,1]``); each frame
    moves to the host as it completes."""
    rgbs, depths, accs = [], [], []
    for p in poses:
        rgb, depth, acc = render_image(
            width, height, focal, p, near, far, coarse_fn, fine_fn,
            coarse_sample_num, fine_sample_num, chunk, perturb,
            generator=generator, device=device)
        rgbs.append(rgb.cpu().numpy())
        depths.append(depth.cpu().numpy())
        accs.append(acc.cpu().numpy())
    return np.stack(rgbs), np.stack(depths), np.stack(accs)

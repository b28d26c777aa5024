"""Alpha compositing of raw (rgb, sigma) samples into pixel values (port of
``msra_practice_project_tpu/ops/composite.py``).

Transmittance is computed in LOG SPACE, ``exp(-cumsum(sigma * dists))``,
never as ``cumprod(1 - alpha + 1e-10)``: the cumprod backward divides by its
inputs, so a near-opaque sample (factor ~1e-10) amplifies the sigma gradient
by ~1e10.  In log space the backward is a cumsum and stays bounded.
"""

from __future__ import annotations

import torch

INF_DIST = 1e10


def raw_to_outputs(raw: torch.Tensor, z_vals: torch.Tensor,
                   rays_d: torch.Tensor, white_bkgd: bool = True,
                   last_dist_mode: str = "inf"):
    """raw ``[..., S, 4]`` (rgb in [0,1], sigma >= 0), z_vals ``[..., S]``,
    rays_d ``[..., 3]``.

    Returns (rgb_map ``[..., 3]``, depth_map ``[...]``, acc_map ``[...]``,
    weights ``[..., S]``), with the white-background composite
    ``rgb += (1 - acc)``.  ``last_dist_mode`` sets the final interval: "inf"
    (the reference's 1e10) or "mean" (the mean real interval).
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    if last_dist_mode == "mean":
        last = dists.mean(dim=-1, keepdim=True)
    else:
        last = torch.full_like(dists[..., :1], INF_DIST)
    dists = torch.cat([dists, last], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    rgb = raw[..., :3]
    tau = raw[..., 3] * dists          # optical depth of each interval
    alpha = -torch.expm1(-tau)         # 1 - exp(-tau), accurate near 0

    # Exclusive transmittance T_i = exp(-sum_{j<i} tau_j).
    trans = torch.exp(-torch.cumsum(tau[..., :-1], dim=-1))
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans], dim=-1)
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, depth_map, acc_map, weights

"""Inputs and weights, made by the benchmark from ``--seed`` on the device,
and handed alike to the program and to the reference.

Every stream is a generator seeded from (seed, stream), so the same seed
gives the same inputs, and a seed of any size (more than 32 bits) works.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WEIGHTS, SCENE, FEED, SAMPLE = 1, 2, 3, 4


def fold(seed: int, stream: int) -> int:
    """The seed of ``stream`` of the run seeded ``seed``."""
    return (int(seed) * 1_000_003 + stream) % (1 << 63)


def generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(fold(seed, stream))


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(fold(seed, stream))


def make_weights(specs, gen: torch.Generator, device) -> dict:
    """Float32 leaves from uniform draws: one draw for every leaf, cut into
    (name, shape, [(count, low, high), ...]) segments."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, segments in specs:
        parts = []
        for count, low, high in segments:
            parts.append(low + (high - low) * u[at:at + count])
            at += count
        out[name] = torch.cat(parts).reshape(shape).contiguous()
    return out


def orbit_rotations(theta, phi) -> torch.Tensor:
    """``rot_theta(theta) @ rot_phi(phi)`` ([..., 3, 3]) of angles in
    radians: a camera on a sphere looking at its centre."""
    ct, st, cp, sp = theta.cos(), theta.sin(), phi.cos(), phi.sin()
    zero = torch.zeros_like(theta)
    return torch.stack([torch.stack([ct, -st * sp, -st * cp], -1),
                        torch.stack([zero, cp, -sp], -1),
                        torch.stack([st, ct * sp, ct * cp], -1)], -2)


def camera_to_world(theta, phi, radius: float) -> torch.Tensor:
    """[..., 4, 4] poses: the rotation and the origin radius * its z
    column."""
    rot = orbit_rotations(theta, phi)
    c2w = torch.zeros(*rot.shape[:-2], 4, 4, dtype=rot.dtype,
                      device=rot.device)
    c2w[..., :3, :3] = rot
    c2w[..., :3, 3] = radius * rot[..., :, 2]
    c2w[..., 3, 3] = 1.0
    return c2w


def pixel_rays(c2w: torch.Tensor, width: int, height: int, focal: float):
    """Origins and directions ``[V, H*W, 3]`` of poses ``[V, 4, 4]``,
    pixels row-major, by elementwise products (no matmul precision)."""
    dev = c2w.device
    j, i = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                       device=dev),
                          torch.arange(width, dtype=torch.float32, device=dev),
                          indexing="ij")
    dirs = torch.stack([(i - width * 0.5) / focal, -(j - height * 0.5) / focal,
                        -torch.ones_like(i)], -1).reshape(-1, 3)
    rays_d = (dirs[None, :, None, :] * c2w[:, None, :3, :3]).sum(-1)
    rays_o = c2w[:, None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d

"""Camera poses and per-pixel rays (port of
``msra_practice_project_tpu/ops/rays.py``).

``camera_pose`` takes radians, ``camera_pose_deg`` degrees.  Poses are
float32 ``[4, 4]`` tensors on the CPU; ``get_rays`` runs on the pose's
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# World-coordinate change-of-basis for Blender scenes
# (ref: nerf/data_loader.py:31-36).
BLENDER_COORD = np.array(
    [
        [-1, 0, 0, 0],
        [0, 0, 1, 0],
        [0, 1, 0, 0],
        [0, 0, 0, 1],
    ],
    dtype=np.float32,
)


def trans_t(t):
    m = torch.eye(4, dtype=torch.float32)
    m[2, 3] = float(t)
    return m


def rot_phi(phi):
    """Pitch (+ down, - up), ref: nerf/data_loader.py:16-21."""
    c, s = math.cos(phi), math.sin(phi)
    return torch.tensor(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
        dtype=torch.float32)


def rot_theta(th):
    """Yaw (+ right, - left), ref: nerf/data_loader.py:24-29."""
    c, s = math.cos(th), math.sin(th)
    return torch.tensor(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]],
        dtype=torch.float32)


def camera_pose(radius, theta, phi):
    """Camera-to-world matrix from a spherical position, angles in RADIANS
    (ref: pi_GAN/render.py:37-49)."""
    c2w = trans_t(radius)
    c2w = rot_phi(phi) @ c2w
    c2w = rot_theta(theta) @ c2w
    return c2w


def camera_pose_deg(radius, theta, phi):
    """Degrees variant (ref: nerf/data_loader.py:39-51)."""
    return camera_pose(radius, math.radians(theta), math.radians(phi))


def pose_to_camera_pos(c2w):
    """Transform matrix -> (radius, theta_deg, phi_deg)
    (ref: nerf/data_loader.py:54-66)."""
    c2w = np.asarray(c2w)
    pos = (c2w @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
    radius = float(np.linalg.norm(pos))
    theta = float(np.arctan2(-pos[0], pos[2])) / np.pi * 180
    phi = float(np.arctan(-pos[1] / np.linalg.norm(pos[::2]))) / np.pi * 180
    return radius, theta, phi


def get_rays(width: int, height: int, focal, c2w: torch.Tensor):
    """Pinhole rays for every pixel (ref: nerf/render.py:7-23).

    Returns (rays_o, rays_d), each ``[H, W, 3]``, on ``c2w``'s device, in
    row-major pixel order.
    """
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    dev = c2w.device
    j, i = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij")
    focal = float(focal)
    dirs = torch.stack(
        [(i - width * 0.5) / focal, -(j - height * 0.5) / focal,
         -torch.ones_like(i)], dim=-1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_flat(width: int, height: int, focal, c2w):
    """``[H*W, 3]`` origins and directions."""
    o, d = get_rays(width, height, focal, c2w)
    return o.reshape(-1, 3), d.reshape(-1, 3)

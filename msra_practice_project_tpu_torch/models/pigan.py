"""pi-GAN: mapping network -> FiLM-SIREN NeRF -> volume renderer, and the
progressive-growing CoordConv discriminator (port of
``msra_practice_project_tpu/models/pigan.py``).

FiLM conditioning is passed functionally, ``trunk(x, film)``, and the
generator renders the whole latent batch in one ``[B, rays, samples]``
computation.  Parameter names follow the JAX param tree (``mapping.trunk``,
``mapping.heads``, ``trunk.input``, ``trunk.hidden``, ``trunk.rgb_hidden``,
``trunk.sigma``, ``trunk.rgb``; ``blocks.i.{res,conv1,conv2}``,
``adapters``, ``out``); ``weights.py`` bridges the two layouts.

Layouts follow the JAX package at the public functions: images are NCHW for
the discriminator, ``render_film`` returns ``[B, H, W, 3]``; convolution
weights are OIHW in both packages.
"""

from __future__ import annotations

import math
import os
import warnings
from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch import nn

from ..core.nn import film_siren_apply, film_siren_init, torch_linear_default
from ..ops.kernels.film_mlp import (FilmTrunkFunction, fused_film_apply,
                                     k8_primal)
from ..ops.rays import get_rays_flat
from ..ops.render import render_rays


# ---------------------------------------------------------------------------
# Mapping network (ref: pi_GAN/modules.py:34-68)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MappingConfig:
    input_dim: int = 256          # z dim (config z_dim, default 1024)
    output_dim: int = 256         # trunk width
    output_layers: int = 8        # heads = output_layers + 1 (= 9)
    hidden_dim: int = 256
    hidden_layers: int = 3


class MappingNetwork(nn.Module):
    """z -> ``[B, output_layers+1, 2*output_dim]`` stacked (gamma||beta) rows.

    Torch-default linear init; head biases gamma=1, beta=0 (the reference's
    "IMPORTANT!!" block, pi_GAN/modules.py:55-58)."""

    def __init__(self, cfg: MappingConfig = MappingConfig(), *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.input_dim] + [cfg.hidden_dim] * cfg.hidden_layers
        self.trunk = nn.ModuleList(
            torch_linear_default(i, o, generator, device)
            for i, o in zip(dims[:-1], dims[1:]))
        self.heads = nn.ModuleList(
            torch_linear_default(cfg.hidden_dim, 2 * cfg.output_dim,
                                 generator, device)
            for _ in range(cfg.output_layers + 1))
        with torch.no_grad():
            for head in self.heads:
                head.bias[:cfg.output_dim] = 1.0
                head.bias[cfg.output_dim:] = 0.0

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z
        for layer in self.trunk:
            h = F.leaky_relu(layer(h), 0.2)
        return torch.stack([head(h) for head in self.heads], dim=-2)


# ---------------------------------------------------------------------------
# FiLM-SIREN NeRF trunk (ref: pi_GAN/modules.py:70-118)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FilmSirenNeRFConfig:
    hidden_dim: int = 256
    hidden_layers: int = 8
    c: float = 6.0
    w0: float = 30.0
    use_dir: bool = True


class FilmSirenNeRF(nn.Module):
    """``trunk(x[..., 6], film[..., n_film, 2h]) -> [..., 4]``.

    film's leading dims must be a prefix of x's (film ``[B, 9, 512]``
    conditions x ``[B, R, S, 6]``); gamma/beta broadcast over the remaining
    axes.  n_film = hidden_layers + 1 (input + 7 hidden + rgb)."""

    def __init__(self, cfg: FilmSirenNeRFConfig = FilmSirenNeRFConfig(), *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.n_film = cfg.hidden_layers + 1
        h = cfg.hidden_dim

        def film_layer(i, o, first=False):
            return film_siren_init(i, o, cfg.c, cfg.w0, first, generator,
                                   device)

        self.input = film_layer(3, h, first=True)
        self.hidden = nn.ModuleList(film_layer(h, h)
                                    for _ in range(cfg.hidden_layers - 1))
        self.rgb_hidden = film_layer(h + 3 if cfg.use_dir else h, h)
        self.sigma = torch_linear_default(h, 1, generator, device)
        self.rgb = torch_linear_default(h, 3, generator, device)

    def _gamma_beta(self, film, i, x_ndim):
        """Head i, with broadcast axes inserted to align with x."""
        h = self.cfg.hidden_dim
        g, b = film[..., i, :h], film[..., i, h:]
        for _ in range(x_ndim - 1 - (film.dim() - 2)):
            g, b = g[..., None, :], b[..., None, :]
        return g, b

    @staticmethod
    def _kernel_batched(x, film) -> bool:
        """The kernels flatten x as ``[film.shape[0], -1, 6]``, so they are
        only right for the batched prefix layout film ``[B, n_film, 2h]`` +
        x ``[B, ..., 6]``; every other broadcast takes the plain path."""
        return film.dim() == 3 and x.dim() >= 2 and x.shape[0] == film.shape[0]

    def forward(self, x, film, need_dx: bool = True):
        """``need_dx=False`` lets the kernels skip the input gradient (zeros
        are returned for it): only when x carries no gradient."""
        mode = self._fused_mode(x.device)
        if mode and not self._kernel_batched(x, film):
            mode = 0
        if mode == 2:
            return fused_film_apply(dict(self.named_parameters()), x, film,
                                    self.cfg.use_dir, need_dx=need_dx)
        if mode == 1:
            return film_trunk_hybrid(self, x, film, need_dx)
        return self._apply_plain(x, film)

    def _fused_mode(self, device) -> int:
        """Trunk dispatch for the standard shape, read from
        ``MSRA_TPU_FUSED_FILM`` as the JAX package reads it: 0 = plain, 1 =
        hybrid (K8 forward in fp32, K7 backward in bf16), 2 = K8 forward and
        K7 backward, both in bf16.  Unset, it is 1 for CUDA tensors and 0
        for any other, as the JAX package takes 0 off the TPU; a value that
        is set wins on either device.  The kernels run on CUDA tensors and
        their plain versions on CPU tensors."""
        cfg = self.cfg
        if not (cfg.hidden_dim == 256 and cfg.hidden_layers == 8
                and cfg.w0 == 30.0):
            return 0
        raw = os.environ.get("MSRA_TPU_FUSED_FILM")
        if raw is None:
            return 1 if torch.device(device).type == "cuda" else 0
        try:
            mode = int(raw)
        except ValueError:
            warnings.warn(f"MSRA_TPU_FUSED_FILM={raw!r} is not an integer; "
                          "using hybrid mode (1)")
            return 1
        if mode not in (0, 1, 2):
            warnings.warn(f"MSRA_TPU_FUSED_FILM={mode} is outside 0-2; "
                          "using hybrid mode (1)")
            return 1
        return mode

    def _apply_plain(self, x, film):
        cfg = self.cfg
        pos, direction = x[..., :3], x[..., 3:6]
        g, b = self._gamma_beta(film, 0, x.dim())
        h = film_siren_apply(self.input, pos, g, b, cfg.w0)
        for i, layer in enumerate(self.hidden):
            g, b = self._gamma_beta(film, i + 1, x.dim())
            h = film_siren_apply(layer, h, g, b, cfg.w0)
        sigma = torch.relu(self.sigma(h))
        if cfg.use_dir:
            h = torch.cat([h, direction], dim=-1)
        g, b = self._gamma_beta(film, cfg.hidden_layers, x.dim())
        h = film_siren_apply(self.rgb_hidden, h, g, b, cfg.w0)
        rgb = torch.sigmoid(self.rgb(h))
        return torch.cat([rgb, sigma], dim=-1)


def film_trunk_hybrid(trunk: FilmSirenNeRF, x, film, need_dx: bool = True):
    """Hybrid mode (``_film_trunk_hybrid`` of the JAX package): the fp32
    trunk forward, recording no graph, and K7 in bf16 as its backward.  The
    JAX package takes XLA's fused forward, the fastest on its TPU; the port
    takes K8 in fp32 (3xTF32 on the card, its plain version on the CPU),
    the same function at the same accuracy."""
    params = dict(trunk.named_parameters())
    names = tuple(params)
    return FilmTrunkFunction.apply(
        x, film, k8_primal(params, trunk.cfg.use_dir, False), names,
        trunk.cfg.use_dir, True, need_dx, *(params[n] for n in names))


# ---------------------------------------------------------------------------
# Generator (ref: pi_GAN/modules.py:121-197)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GeneratorConfig:
    z_dim: int = 1024
    resolution: int = 32
    near: float = 0.5
    far: float = 1.5
    fov: float = 12.0           # degrees; focal = W/2 / tan(fov/2)
    coarse_samples: int = 12
    fine_samples: int = 24
    horizontal_std: float = 0.45  # radians (pi_GAN/train.py:49)
    vertical_std: float = 0.15
    use_dir: bool = True

    @property
    def focal(self) -> float:
        return self.resolution / 2.0 / math.tan(
            self.fov / 2.0 * math.pi / 180.0)

    def with_resolution(self, resolution: int) -> "GeneratorConfig":
        return replace(self, resolution=resolution)

    def with_render(self, **kw) -> "GeneratorConfig":
        return replace(self, **kw)


def camera_poses(theta: torch.Tensor, phi: torch.Tensor,
                 radius: float = 1.0) -> torch.Tensor:
    """Camera-to-world matrices ``[B, 4, 4]`` for angles ``[B]`` in radians:
    ``rot_theta(theta) @ rot_phi(phi) @ trans_t(radius)``
    (ref: pi_GAN/render.py:37-49), on the angles' device."""
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    rot_theta = torch.stack([
        torch.stack([ct, zero, -st, zero], -1),
        torch.stack([zero, one, zero, zero], -1),
        torch.stack([st, zero, ct, zero], -1),
        torch.stack([zero, zero, zero, one], -1)], -2)
    rot_phi = torch.stack([
        torch.stack([one, zero, zero, zero], -1),
        torch.stack([zero, cp, -sp, zero], -1),
        torch.stack([zero, sp, cp, zero], -1),
        torch.stack([zero, zero, zero, one], -1)], -2)
    trans = torch.eye(4, dtype=theta.dtype, device=theta.device).expand(
        theta.shape[0], 4, 4).clone()
    trans[:, 2, 3] = radius
    return rot_theta @ (rot_phi @ trans)


class Generator(nn.Module):
    """Full pi-GAN generator: z -> film -> batched volume render.

    ``forward(z[B, z_dim], resolution)`` returns images ``[B, 3, H, W]``
    (NCHW, as the discriminator takes them) at a random camera pose per
    latent, theta ~ N(0, h_std), phi ~ N(0, v_std) radians
    (ref: pi_GAN/modules.py:154-162).  Randomness comes from ``generator``,
    or the caller injects the poses and the stratified jitter."""

    def __init__(self, cfg: GeneratorConfig = GeneratorConfig(), *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.mapping = MappingNetwork(MappingConfig(input_dim=cfg.z_dim),
                                      generator=generator, device=device)
        self.trunk = FilmSirenNeRF(FilmSirenNeRFConfig(use_dir=cfg.use_dir),
                                   generator=generator, device=device)

    def get_mapping(self, z):
        return self.mapping(z)

    def sample_poses(self, batch: int, generator=None, device=None):
        """theta, phi ``[batch]`` from the training pose prior."""
        theta = torch.randn(batch, generator=generator, device=device)
        phi = torch.randn(batch, generator=generator, device=device)
        return (theta * self.cfg.horizontal_std,
                phi * self.cfg.vertical_std)

    def render_film(self, film, theta, phi, resolution: int | None = None,
                    coarse_samples: int | None = None,
                    fine_samples: int | None = None, fov=None, *,
                    generator=None, jitter=None):
        """Render film codes ``[B, n_film, 2h]`` at poses (theta, phi)
        ``[B]`` -> ``[B, H, W, 3]``.  The trunk is both the coarse and the
        fine model (pi_GAN/modules.py:160-161).  ``fov`` (degrees, a float
        or a 0-d tensor) replaces ``cfg.fov``; ``jitter`` ``[B, H*W,
        coarse]`` replaces the stratified draws from ``generator``."""
        cfg = self.cfg
        res = resolution or cfg.resolution
        nc = coarse_samples or cfg.coarse_samples
        nf = fine_samples or cfg.fine_samples
        # focal in fp32, as the JAX package computes it: from cfg.fov's
        # angle rounded once, or from a given fov in fp32 arithmetic (JAX
        # traces that argument as an fp32 scalar)
        if fov is None:
            half = torch.tensor(cfg.fov / 2.0 * math.pi / 180.0,
                                dtype=torch.float32)
        else:
            half = torch.as_tensor(fov, dtype=torch.float32) / 2.0 \
                * math.pi / 180.0
        focal = res / 2.0 / torch.tan(half)
        rays_o, rays_d = get_rays_flat(res, res, focal,
                                       camera_poses(theta, phi))

        # need_dx=False: the points are functions of pose/ray data and the
        # (detached) coarse weights, so their gradients are dead work.
        def model_fn(x):
            return self.trunk(x, film, need_dx=False)

        # The coarse pass only places the fine samples (its weights are
        # detached and its rgb is dropped), so it records no graph: eager
        # autograd would keep its residuals alive through the fine pass.
        def coarse_fn(x):
            with torch.no_grad():
                return model_fn(x)

        # last_dist_mode="mean": bound the final sample interval instead of
        # the reference's 1e10 tail (pi_GAN/render.py:137), whose
        # d alpha / d sigma ~ 1e10 poisons the G gradients where the
        # background shows.
        out = render_rays(rays_o, rays_d, cfg.near, cfg.far, coarse_fn,
                          model_fn, nc, nf, last_dist_mode="mean",
                          generator=generator, jitter=jitter)
        return out["rgb_fine"].reshape(film.shape[0], res, res, 3)

    def forward(self, z, resolution: int | None = None, *, generator=None,
                poses=None, jitter=None):
        """z ``[B, z_dim]`` -> images ``[B, 3, H, W]``; ``poses`` (theta,
        phi) replaces the draws from ``generator``."""
        film = self.get_mapping(z)
        if poses is None:
            poses = self.sample_poses(z.shape[0], generator, z.device)
        imgs = self.render_film(film, *poses, resolution,
                                generator=generator, jitter=jitter)
        return imgs.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Discriminator (ref: pi_GAN/modules.py:205-317)
# ---------------------------------------------------------------------------


def _conv_init(in_ch, out_ch, k, generator=None, device=None,
               padding=0) -> nn.Conv2d:
    """torch.nn.Conv2d's default init drawn from ``generator``:
    U(+-1/sqrt(fan_in)) for the weight [O, I, kh, kw] and the bias."""
    conv = nn.Conv2d(in_ch, out_ch, k, padding=padding, device=device)
    bound = 1.0 / math.sqrt(in_ch * k * k)
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        conv.bias.uniform_(-bound, bound, generator=generator)
    return conv


def add_coords(x: torch.Tensor) -> torch.Tensor:
    """Append normalised row/col coordinate channels in [-1, 1]
    (ref: pi_GAN/modules.py:205-239, CoordConv)."""
    n, _, h, w = x.shape
    rows = torch.linspace(-1.0, 1.0, h, dtype=x.dtype, device=x.device)
    cols = torch.linspace(-1.0, 1.0, w, dtype=x.dtype, device=x.device)
    coords = torch.stack([rows[:, None].expand(h, w),
                          cols[None, :].expand(h, w)])
    return torch.cat([x, coords[None].expand(n, 2, h, w)], dim=1)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2)


@dataclass(frozen=True)
class DiscriminatorConfig:
    # Channel ladder 64 -> 128 -> 256 -> 400 -> 400 -> 400 over 64^2 -> 2^2
    # (ref: pi_GAN/modules.py:284-290).
    channels: tuple = (64, 128, 256, 400, 400, 400)


class _Block(nn.Module):
    def __init__(self, cin, cout, generator, device):
        super().__init__()
        self.res = _conv_init(cin, cout, 1, generator, device)
        self.conv1 = _conv_init(cin + 2, cout, 3, generator, device, 1)
        self.conv2 = _conv_init(cout + 2, cout, 3, generator, device, 1)

    def forward(self, x):
        res = self.res(x)
        h = F.leaky_relu(self.conv1(add_coords(x)), 0.2)
        h = self.conv2(add_coords(h))
        return avg_pool2(F.leaky_relu(h + res, 0.2))


class Discriminator(nn.Module):
    """Progressive-growing CoordConv discriminator with fade-in.

    ``forward(x[N,3,H,W], resolution, alpha)``: alpha in [0, 1) blends the
    entry block with the downsampled skip; alpha < 0 (or >= 1) disables the
    fade-in (ref: pi_GAN/modules.py:304-317)."""

    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig(), *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        ch = cfg.channels
        self.n_layers = len(ch) - 1
        self.blocks = nn.ModuleList(
            _Block(ch[i], ch[i + 1], generator, device)
            for i in range(self.n_layers))
        self.adapters = nn.ModuleList(
            _conv_init(3, ch[i], 1, generator, device)
            for i in range(self.n_layers))
        self.out = _conv_init(ch[-1], 1, 2, generator, device)

    def _entry(self, resolution: int) -> int:
        step = self.n_layers - int(math.log2(resolution)) + 1
        if not 0 <= step < len(self.adapters):
            top = 2 ** (self.n_layers + 1)
            raise ValueError(
                f"resolution {resolution} outside the discriminator's "
                f"progressive ladder 4..{top}")
        return step

    def forward(self, x, resolution: int, alpha: float = -1.0):
        step = self._entry(resolution)
        h = F.leaky_relu(self.adapters[step](x), 0.2)
        for i in range(step, self.n_layers):
            h = self.blocks[i](h)
            if i == step and step + 1 < len(self.adapters) \
                    and 0.0 <= alpha < 1.0:
                skip = F.leaky_relu(self.adapters[step + 1](avg_pool2(x)),
                                    0.2)
                h = (1.0 - alpha) * skip + alpha * h
        return self.out(h).reshape(x.shape[0])

    def apply_features(self, x, resolution: int):
        """Penultimate activations pooled to ``[N, 2*C]`` (spatial mean ‖
        std), read at the full entry resolution without fade-in
        (``apply_features`` of the JAX package)."""
        step = self._entry(resolution)
        h = F.leaky_relu(self.adapters[step](x), 0.2)
        for i in range(step, self.n_layers):
            h = self.blocks[i](h)
        return torch.cat([h.mean(dim=(2, 3)),
                          h.std(dim=(2, 3), unbiased=False)], dim=1)

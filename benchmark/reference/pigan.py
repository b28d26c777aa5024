"""Plain float32 pi-GAN (Chan et al., arXiv:2012.00926): the mapping
network, the FiLM-SIREN radiance field, its volume render, the progressive
CoordConv discriminator, the non-saturating losses with R1, and both Adams,
as the configuration's source code lays them out.

The sine is ``torch.sin``.  Departures from the paper, each the source
code's: the last sample interval is the mean interval, not 1e10; the coarse
pass only places the fine samples, which invert the CDF at a uniform grid of
``u``; the background is white; the losses keep the source's signs.

Weights are a dict of leaves under the names of ``param_specs`` (``[out,
in]`` for dense, OIHW for convolutions).  Each part's products take the
precision ``prec`` names for it ("fp32" throughout in the reference).  The
gradients of a step are summed over blocks of images, so a batch of any
size fits.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import adam as adam_lib
from .nerf import composite, sample_pdf
from .precision import conv2d, linear

FP32 = {"mapping": "fp32", "trunk_fwd": "fp32", "trunk_bwd": "fp32",
        "disc": "fp32"}


def _uniform(name, shape, bound):
    return (name, shape, [(math.prod(shape), -bound, bound)])


def param_specs(cfg: dict) -> list:
    """(name, shape, [(count, low, high), ...]) of every leaf of G and D
    (uniform draws, the segments in flat order), as the source inits them:
    torch's default for dense and convolution layers, the FiLM-SIREN init in
    the trunk, and the mapping heads' biases gamma = 1, beta = 0."""
    g, d = cfg["generator"], cfg["discriminator"]
    w, z = g["hidden_dim"], cfg["z_dim"]
    specs = []
    dims = [z] + [g["mapping_hidden_dim"]] * g["mapping_hidden_layers"]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        specs += [_uniform(f"g.mapping.trunk.{i}.weight", (b, a), a ** -0.5),
                  _uniform(f"g.mapping.trunk.{i}.bias", (b,), a ** -0.5)]
    h = dims[-1]
    for i in range(g["hidden_layers"] + 1):
        specs += [_uniform(f"g.mapping.heads.{i}.weight", (2 * w, h),
                           h ** -0.5),
                  (f"g.mapping.heads.{i}.bias", (2 * w,),
                   [(w, 1.0, 1.0), (w, 0.0, 0.0)])]
    c, w0 = g["film_c"], g["w0"]
    layers = ([("input", 3, True)]
              + [(f"hidden.{i}", w, False)
                 for i in range(g["hidden_layers"] - 1)]
              + [("rgb_hidden", w + (3 if cfg["use_dir"] else 0), False)])
    for name, fan_in, first in layers:
        bound = 1.0 / fan_in if first else math.sqrt(c / fan_in) / w0
        specs += [_uniform(f"g.trunk.{name}.weight", (w, fan_in), bound),
                  _uniform(f"g.trunk.{name}.bias", (w,), fan_in ** -0.5)]
    for name, out in (("sigma", 1), ("rgb", 3)):
        specs += [_uniform(f"g.trunk.{name}.weight", (out, w), w ** -0.5),
                  _uniform(f"g.trunk.{name}.bias", (out,), w ** -0.5)]
    ch = d["channels"]

    def conv(name, cin, cout, k):
        bound = (cin * k * k) ** -0.5
        return [_uniform(f"d.{name}.weight", (cout, cin, k, k), bound),
                _uniform(f"d.{name}.bias", (cout,), bound)]

    for i in range(len(ch) - 1):
        specs += conv(f"blocks.{i}.res", ch[i], ch[i + 1], 1)
        specs += conv(f"blocks.{i}.conv1", ch[i] + 2, ch[i + 1], 3)
        specs += conv(f"blocks.{i}.conv2", ch[i + 1] + 2, ch[i + 1], 3)
        specs += conv(f"adapters.{i}", 3, ch[i], 1)
    specs += conv("out", ch[-1], 1, 2)
    return specs


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------


def mapping(p, z, n_heads: int, prec=FP32):
    """z -> film ``[B, n_heads, 2 * width]`` (gamma || beta per layer)."""
    m = prec["mapping"]
    h = z
    i = 0
    while f"g.mapping.trunk.{i}.weight" in p:
        h = F.leaky_relu(linear(h, p[f"g.mapping.trunk.{i}.weight"],
                                p[f"g.mapping.trunk.{i}.bias"], m, m), 0.2)
        i += 1
    return torch.stack([linear(h, p[f"g.mapping.heads.{j}.weight"],
                               p[f"g.mapping.heads.{j}.bias"], m, m)
                        for j in range(n_heads)], dim=-2)


def trunk(p, x, film, cfg, prec=FP32):
    """x ``[B, ..., 6]`` under film ``[B, n, 2w]`` -> ``[B, ..., 4]``:
    sin(w0 (gamma (W h + b) + beta)) layers, a ReLU density from the last
    hidden layer, and rgb from one more FiLM layer over (h, direction)."""
    g = cfg["generator"]
    w, w0 = g["hidden_dim"], g["w0"]
    fwd, bwd = prec["trunk_fwd"], prec["trunk_bwd"]
    extra = x.dim() - 2

    def film_layer(name, i, h):
        gamma = film[:, i, :w].reshape(-1, *[1] * extra, w)
        beta = film[:, i, w:].reshape(-1, *[1] * extra, w)
        lin = linear(h, p[f"g.trunk.{name}.weight"],
                     p[f"g.trunk.{name}.bias"], fwd, bwd)
        return torch.sin(w0 * (gamma * lin + beta))

    h = film_layer("input", 0, x[..., :3])
    for i in range(g["hidden_layers"] - 1):
        h = film_layer(f"hidden.{i}", i + 1, h)
    sigma = torch.relu(linear(h, p["g.trunk.sigma.weight"],
                              p["g.trunk.sigma.bias"], fwd, bwd))
    if cfg["use_dir"]:
        h = torch.cat([h, x[..., 3:6]], dim=-1)
    h = film_layer("rgb_hidden", g["hidden_layers"], h)
    rgb = torch.sigmoid(linear(h, p["g.trunk.rgb.weight"],
                               p["g.trunk.rgb.bias"], fwd, bwd))
    return torch.cat([rgb, sigma], dim=-1)


def camera_rays(theta, phi, res: int, fov_deg: float, radius: float = 1.0):
    """Origins and directions ``[B, res*res, 3]`` of pinhole cameras at
    ``rot_theta(theta) rot_phi(phi) trans_z(radius)``, pixels row-major."""
    half = torch.tensor(fov_deg / 2.0 * math.pi / 180.0, dtype=torch.float32)
    focal = float(res / 2.0 / torch.tan(half))
    dev = theta.device
    j, i = torch.meshgrid(torch.arange(res, dtype=torch.float32, device=dev),
                          torch.arange(res, dtype=torch.float32, device=dev),
                          indexing="ij")
    dirs = torch.stack([(i - res * 0.5) / focal, -(j - res * 0.5) / focal,
                        -torch.ones_like(i)], -1).reshape(-1, 3)
    ct, st, cp, sp = theta.cos(), theta.sin(), phi.cos(), phi.sin()
    zero = torch.zeros_like(theta)
    # rows of rot_theta[:3, :3] @ rot_phi[:3, :3]
    rot = torch.stack([torch.stack([ct, -st * sp, -st * cp], -1),
                       torch.stack([zero, cp, -sp], -1),
                       torch.stack([st, ct * sp, ct * cp], -1)], -2)
    rays_d = (dirs[None, :, None, :] * rot[:, None, :, :]).sum(-1)
    rays_o = (radius * rot[:, :, 2])[:, None, :].expand(rays_d.shape)
    return rays_o, rays_d


def render(p, film, theta, phi, jitter, res, cfg, prec=FP32):
    """Images ``[B, 3, res, res]`` of film codes at poses (theta, phi): a
    coarse pass with no graph at stratified depths (``jitter`` ``[B,
    res*res, nc]``), then the fine pass at the sorted union."""
    nc, nf = cfg["render_coarse_sample_num"], cfg["render_fine_sample_num"]
    near, far = cfg["render_near"], cfg["render_far"]
    rays_o, rays_d = camera_rays(theta, phi, res, cfg["generator"]["fov"])
    view = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    t = torch.linspace(near, far, nc, device=film.device)
    mids = 0.5 * (t[1:] + t[:-1])
    lo, hi = torch.cat([t[:1], mids]), torch.cat([mids, t[-1:]])
    z = lo + (hi - lo) * jitter

    def points(z):
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., None]
        return torch.cat([pts, view[..., None, :].expand(pts.shape)], -1)

    with torch.no_grad():
        raw = trunk(p, points(z), film, cfg, prec)
        *_, weights = composite(raw, z, rays_d, "mean")
    z_fine = sample_pdf(mids.expand(*z.shape[:-1], nc - 1),
                        weights[..., 1:-1], nf)
    z_all, _ = torch.sort(torch.cat([z, z_fine], dim=-1), dim=-1)
    rgb, *_ = composite(trunk(p, points(z_all), film, cfg, prec), z_all,
                        rays_d, "mean")
    return rgb.reshape(-1, res, res, 3).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------


def _coords(x):
    n, _, h, w = x.shape
    rows = torch.linspace(-1.0, 1.0, h, device=x.device)
    cols = torch.linspace(-1.0, 1.0, w, device=x.device)
    grid = torch.stack([rows[:, None].expand(h, w),
                        cols[None, :].expand(h, w)])
    return torch.cat([x, grid[None].expand(n, 2, h, w)], dim=1)


def discriminator(p, x, res: int, alpha: float, n_layers: int, prec=FP32):
    """Logits ``[N]`` of images ``x [N, 3, res, res]``: the entry adapter at
    this resolution, the residual CoordConv blocks down to 2x2, with the
    fade-in blend of the next adapter over pooled x when 0 <= alpha < 1."""
    c = prec["disc"]

    def conv(name, h, pad=0):
        return conv2d(h, p[f"d.{name}.weight"], p[f"d.{name}.bias"], pad, c)

    step = n_layers - int(math.log2(res)) + 1
    h = F.leaky_relu(conv(f"adapters.{step}", x), 0.2)
    for i in range(step, n_layers):
        res_path = conv(f"blocks.{i}.res", h)
        y = F.leaky_relu(conv(f"blocks.{i}.conv1", _coords(h), 1), 0.2)
        y = conv(f"blocks.{i}.conv2", _coords(y), 1)
        h = F.avg_pool2d(F.leaky_relu(y + res_path, 0.2), 2)
        if i == step and step + 1 < n_layers and 0.0 <= alpha < 1.0:
            skip = F.leaky_relu(conv(f"adapters.{step + 1}",
                                     F.avg_pool2d(x, 2)), 0.2)
            h = (1.0 - alpha) * skip + alpha * h
    return conv("out", h).reshape(x.shape[0])


# ---------------------------------------------------------------------------
# Train iterations
# ---------------------------------------------------------------------------


def _grads(loss, leaves: dict, into: dict):
    names = list(leaves)
    for k, g in zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names], allow_unused=True)):
        if g is not None:
            into[k] += g


class Trainer:
    """Train from ``params`` (copied).  ``iteration(it)`` runs a D step (the
    fakes without a graph; the non-saturating loss plus r1_lambda * R1 on
    the reals) then a G step, each followed by its Adam, and returns
    (d_loss, g_loss).  ``it`` holds ``real`` and, for the D step (``d_``)
    and the G step (``g_``), ``z``, ``theta``, ``phi`` and ``jitter``.  The
    G step's gradient is summed over blocks of images.  ``first`` holds the
    first D and G gradients."""

    def __init__(self, params: dict, cfg: dict, stage: dict, prec=FP32,
                 rays_per_block: int = 8192):
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.g = {k: v for k, v in self.params.items() if k.startswith("g.")}
        self.d = {k: v for k, v in self.params.items() if k.startswith("d.")}
        betas = tuple(cfg["adam_betas"])
        self.g_opt = adam_lib.Adam(self.g, adam_lib.interp_lr(
            cfg["generator_lr"], cfg["generator_lr_end"], cfg["lr_decay"]),
            betas)
        self.d_opt = adam_lib.Adam(self.d, adam_lib.interp_lr(
            cfg["discriminator_lr"], cfg["discriminator_lr_end"],
            cfg["lr_decay"]), betas)
        self.cfg, self.prec = cfg, prec
        self.res, self.alpha = stage["resolution"], stage["fade_alpha"]
        self.n_heads = cfg["generator"]["hidden_layers"] + 1
        self.n_layers = len(cfg["discriminator"]["channels"]) - 1
        self.block = max(1, rays_per_block // (self.res * self.res))
        self.first = {}

    def _fakes(self, it, prefix, with_graph):
        n = it[prefix + "z"].shape[0]
        for lo in range(0, n, self.block):
            rows = slice(lo, lo + self.block)
            with torch.set_grad_enabled(with_graph):
                film = mapping(self.params, it[prefix + "z"][rows],
                               self.n_heads, self.prec)
                yield render(self.params, film, it[prefix + "theta"][rows],
                             it[prefix + "phi"][rows],
                             it[prefix + "jitter"][rows], self.res, self.cfg,
                             self.prec)

    def _disc(self, x):
        return discriminator(self.params, x, self.res, self.alpha,
                             self.n_layers, self.prec)

    def iteration(self, it):
        n = it["real"].shape[0]
        fake = torch.cat(list(self._fakes(it, "d_", False)))
        real = it["real"].clone().requires_grad_(True)
        fake_label, real_label = self._disc(fake), self._disc(real)
        (dx,) = torch.autograd.grad(real_label.sum(), real, create_graph=True)
        r1 = dx.reshape(n, -1).pow(2).sum(-1).mean()
        d_loss = (F.softplus(-fake_label).mean()
                  + F.softplus(real_label).mean()
                  + self.cfg["r1_lambda"] * r1)
        d_grads = {k: torch.zeros_like(v) for k, v in self.d.items()}
        _grads(d_loss, self.d, d_grads)
        self.d_opt.step(d_grads)

        g_grads = {k: torch.zeros_like(v) for k, v in self.g.items()}
        g_loss = torch.zeros((), device=real.device)
        for img in self._fakes(it, "g_", True):
            part = -F.softplus(-self._disc(img)).sum() / n
            _grads(part, self.g, g_grads)
            g_loss += part.detach()
        if not self.first:
            self.first = {**{k: v.clone() for k, v in d_grads.items()},
                          **{k: v.clone() for k, v in g_grads.items()}}
        self.g_opt.step(g_grads)
        return d_loss.detach(), g_loss

    def leaves(self) -> dict:
        return {k: v.detach().clone() for k, v in self.params.items()}

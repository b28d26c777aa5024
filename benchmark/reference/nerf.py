"""Plain float32 NeRF: the MLP, hierarchical volume rendering and the train
step, as Mildenhall et al. (arXiv:2003.08934) describe them and as the
configuration's source code lays them out.

Departures from the paper, each the source code's: the positional encoding
has no pi factor and interleaves ``[sin(2^k x), cos(2^k x)]`` per frequency;
the transmittance is ``exp(-cumsum(sigma * delta))``, the paper's product of
``1 - alpha`` taken in log space (without its 1e-10 guard); the fine samples
invert the CDF at a uniform grid of ``u``; the background is white.

Weights are a dict of ``[out, in]`` leaves under the names of
``param_specs``.  Every product takes the precision of its part from
``prec`` ({"mlp_fwd", "mlp_bwd"}: "fp32" in the reference, lower in a
control).  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

from . import adam as adam_lib
from .precision import linear

FP32 = {"mlp_fwd": "fp32", "mlp_bwd": "fp32"}


def layer_dims(net: dict) -> list:
    """(name, in, out, activation) of every dense layer of one MLP."""
    w = net["mlp_width"]
    pe_pos = 3 * 2 * net["pe_pos_length"]
    pe_dir = 3 * 2 * net["pe_dir_length"]
    skip = net["skip_after"]
    rows = [("layers_pos.0", pe_pos, w, "relu")]
    for i in range(1, net["mlp_depth"]):
        rows.append((f"layers_pos.{i}", w + (pe_pos if i == skip + 1 else 0),
                     w, "relu"))
    rows += [("sigma", w, 1, "relu"), ("layers_dir.0", w, w, "linear"),
             ("layers_dir.1", w + pe_dir, net["dir_width"], "relu"),
             ("rgb", net["dir_width"], 3, "sigmoid")]
    return rows


GAINS = {"relu": math.sqrt(2.0), "linear": 1.0, "sigmoid": 1.0}


def param_specs(cfg: dict) -> list:
    """(name, shape, [(count, low, high)]) of every leaf of the coarse and
    fine MLPs (uniform draws): Xavier-uniform weights with the activation's
    gain, zero biases, as the source inits them."""
    specs = []
    models = ("coarse", "fine") if cfg["use_fine_model"] else ("coarse",)
    for model in models:
        for name, i, o, act in layer_dims(cfg["net"]):
            bound = GAINS[act] * math.sqrt(6.0 / (i + o))
            specs.append((f"{model}.{name}.weight", (o, i),
                          [(o * i, -bound, bound)]))
            specs.append((f"{model}.{name}.bias", (o,), [(o, 0.0, 0.0)]))
    return specs


def positional_encoding(x: torch.Tensor, length: int) -> torch.Tensor:
    freqs = 2.0 ** torch.arange(length, dtype=x.dtype, device=x.device)
    xs = x[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(xs), torch.cos(xs)], dim=-2)
    return enc.reshape(*x.shape[:-1], 2 * length * x.shape[-1])


def mlp(params: dict, prefix: str, x: torch.Tensor, net: dict,
        prec: dict = FP32) -> torch.Tensor:
    """x ``[..., 6]`` (position, direction) -> ``[..., 4]`` (rgb, sigma)."""
    p, fwd, bwd = params, prec["mlp_fwd"], prec["mlp_bwd"]

    def dense(name, h):
        return linear(h, p[f"{prefix}.{name}.weight"],
                      p[f"{prefix}.{name}.bias"], fwd, bwd)

    e_pos = positional_encoding(x[..., :3], net["pe_pos_length"])
    e_dir = positional_encoding(x[..., 3:6], net["pe_dir_length"])
    h = e_pos
    for i in range(net["mlp_depth"]):
        if i == net["skip_after"] + 1:
            h = torch.cat([e_pos, h], dim=-1)
        h = torch.relu(dense(f"layers_pos.{i}", h))
    sigma = torch.relu(dense("sigma", h))
    h = dense("layers_dir.0", h)
    h = torch.relu(dense("layers_dir.1", torch.cat([h, e_dir], dim=-1)))
    rgb = torch.sigmoid(dense("rgb", h))
    return torch.cat([rgb, sigma], dim=-1)


def composite(raw, z, rays_d, last_dist: str = "inf"):
    """(rgb, depth, acc, weights) of samples ``raw [R, S, 4]`` at depths
    ``z [R, S]``, over a white background."""
    dists = z[..., 1:] - z[..., :-1]
    last = (dists.mean(dim=-1, keepdim=True) if last_dist == "mean"
            else torch.full_like(dists[..., :1], 1e10))
    dists = torch.cat([dists, last], dim=-1) * torch.linalg.norm(
        rays_d, dim=-1, keepdim=True)
    tau = raw[..., 3] * dists
    alpha = -torch.expm1(-tau)
    trans = torch.exp(-torch.cat([torch.zeros_like(tau[..., :1]),
                                  torch.cumsum(tau[..., :-1], dim=-1)], -1))
    weights = alpha * trans
    rgb = (weights[..., None] * raw[..., :3]).sum(dim=-2)
    acc = weights.sum(dim=-1)
    depth = (weights * z).sum(dim=-1)
    return rgb + (1.0 - acc[..., None]), depth, acc, weights


def sample_pdf(bins, weights, n: int):
    """n depths by inverting the CDF of ``weights + 1e-5`` over ``bins`` at
    a uniform grid of u in [0, 1]."""
    bins, weights = bins.detach(), weights.detach() + 1e-5
    cdf = torch.cumsum(weights / weights.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    u = torch.linspace(0.0, 1.0, n, device=cdf.device).expand(
        *cdf.shape[:-1], n).contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (idx - 1).clamp(0, cdf.shape[-1] - 1)
    above = idx.clamp(0, cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    span = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / span * (b1 - b0)


def render_rays(params, net, rays_o, rays_d, jitter, near, far, nc, nf,
                prec=FP32, fine_prefix="fine"):
    """Coarse pass at stratified depths (``jitter`` ``[R, nc]`` in [0, 1)),
    fine pass at the sorted union with ``nf`` importance samples.  Returns
    ((rgb, depth, acc) coarse, (rgb, depth, acc) fine)."""
    view = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    t = torch.linspace(near, far, nc, device=rays_o.device)
    mids = 0.5 * (t[1:] + t[:-1])
    lo = torch.cat([t[:1], mids])
    hi = torch.cat([mids, t[-1:]])
    z = lo + (hi - lo) * jitter

    def run(prefix, z):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        x = torch.cat([pts, view[:, None, :].expand(pts.shape)], dim=-1)
        return composite(mlp(params, prefix, x, net, prec), z, rays_d)

    rgb_c, depth_c, acc_c, w = run("coarse", z)
    z_fine = sample_pdf(mids.expand(z.shape[0], nc - 1), w[..., 1:-1], nf)
    z_all, _ = torch.sort(torch.cat([z, z_fine], dim=-1), dim=-1)
    rgb_f, depth_f, acc_f, _ = run(fine_prefix, z_all)
    return (rgb_c, depth_c, acc_c), (rgb_f, depth_f, acc_f)


class Trainer:
    """Train from ``params`` (copied): coarse plus fine MSE on rgb, Adam
    over both MLPs.  ``step(batch [B, 10], jitter [B, nc])`` (origin,
    direction, rgba; stratified jitter) returns the step's loss; each
    step's gradient is summed over ray blocks of ``chunk``.  ``first``
    holds the first step's gradients."""

    def __init__(self, params: dict, cfg: dict, prec=FP32,
                 chunk: int = 1024):
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.opt = adam_lib.Adam(self.params, adam_lib.exponential_lr(
            cfg["learning_rate"], cfg["learning_rate_decay"]))
        self.cfg, self.prec, self.chunk = cfg, prec, chunk
        self.first = None

    def step(self, batch, jitter):
        cfg, params = self.cfg, self.params
        fine = "fine" if cfg["use_fine_model"] else "coarse"
        n = batch.shape[0]
        names = list(params)
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = torch.zeros((), device=batch.device)
        for lo in range(0, n, self.chunk):
            rows = batch[lo:lo + self.chunk]
            c, f = render_rays(params, cfg["net"], rows[:, 0:3], rows[:, 3:6],
                               jitter[lo:lo + self.chunk], cfg["render_near"],
                               cfg["render_far"],
                               cfg["render_coarse_sample_num"],
                               cfg["render_fine_sample_num"], self.prec, fine)
            target = rows[:, 6:9]
            loss = ((f[0] - target) ** 2).sum() / (3 * n)
            if cfg["use_fine_model"]:
                loss = loss + ((c[0] - target) ** 2).sum() / (3 * n)
            for k, g in zip(names, torch.autograd.grad(
                    loss, [params[k] for k in names], allow_unused=True)):
                if g is not None:
                    grads[k] += g
            total += loss.detach()
        if self.first is None:
            self.first = {k: g.clone() for k, g in grads.items()}
        self.opt.step(grads)
        return total

    def leaves(self) -> dict:
        return {k: v.detach().clone() for k, v in self.params.items()}


@torch.no_grad()
def render_view(params, cfg, rays_o, rays_d, jitter, chunk: int = 16384,
                prec=FP32):
    """A whole view's (rgb ``[N, 3]``, depth ``[N]``, acc ``[N]``) from the
    fine pass, ray block after ray block."""
    fine = "fine" if cfg["use_fine_model"] else "coarse"
    out = []
    for lo in range(0, rays_o.shape[0], chunk):
        _, f = render_rays(params, cfg["net"], rays_o[lo:lo + chunk],
                           rays_d[lo:lo + chunk], jitter[lo:lo + chunk],
                           cfg["render_near"], cfg["render_far"],
                           cfg["render_coarse_sample_num"],
                           cfg["render_fine_sample_num"], prec, fine)
        out.append(torch.cat([f[0], f[1][:, None], f[2][:, None]], dim=-1))
    out = torch.cat(out)
    return out[:, :3], out[:, 3], out[:, 4]

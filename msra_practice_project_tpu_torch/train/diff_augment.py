"""Differentiable augmentation for GAN discriminators (DiffAugment; port of
``msra_practice_project_tpu/train/diff_augment.py``).

Zhao et al. 2020: the same random, differentiable augmentations on real and
fake images before D, in both losses, so D cannot memorise a small real set
while G still gets gradients through the augmented fakes.  Off by default
(the reference's dynamics); ``diff_augment`` in a config names the ops, e.g.
"color,translation,cutout".

Each op takes NCHW images in [0, 1] and its per-image draws; ``draw`` makes
them from an explicit ``torch.Generator`` and ``augment`` applies a policy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import mesh


def brightness(x, b):
    """x + b per image, b ~ U(-0.5, 0.5)."""
    return x + b[:, None, None, None]


def saturation(x, s):
    """(x - mean_c) * s + mean_c per image, s ~ U(0, 2)."""
    mean = x.mean(dim=1, keepdim=True)
    return (x - mean) * s[:, None, None, None] + mean


def contrast(x, c):
    """(x - mean_chw) * c + mean_chw per image, c ~ U(0.5, 1.5)."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * c[:, None, None, None] + mean


def color(x, b, s, c):
    return contrast(saturation(brightness(x, b), s), c)


def _shift(x, ratio):
    return max(int(x.shape[2] * ratio), 1), max(int(x.shape[3] * ratio), 1)


def translation(x, ty, tx, ratio=0.125):
    """Per-image integer shift (ty, tx) in [-ratio*size, ratio*size],
    zero-padded (no wrap)."""
    n, _, h, w = x.shape
    sh, sw = _shift(x, ratio)
    pad = F.pad(x, (sw, sw, sh, sh)).permute(0, 2, 3, 1)   # [n, H, W, c]
    iy = torch.arange(h, device=x.device)[None] + sh + ty[:, None]
    ix = torch.arange(w, device=x.device)[None] + sw + tx[:, None]
    bi = torch.arange(n, device=x.device)[:, None, None]
    return pad[bi, iy[:, :, None], ix[:, None, :]].permute(0, 3, 1, 2)


def cutout(x, oy, ox, ratio=0.5):
    """Zero one (ratio*h, ratio*w) square per image with its top-left corner
    at (oy, ox); the window is clipped at the borders."""
    _, _, h, w = x.shape
    ch, cw = _shift(x, ratio)
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    oy, ox = oy[:, None, None], ox[:, None, None]
    inside = (yy >= oy) & (yy < oy + ch) & (xx >= ox) & (xx < ox + cw)
    return x * (~inside)[:, None].to(x.dtype)


def _uniform(n, lo, hi, generator, device):
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)


def draw(name: str, x, generator=None, n: int | None = None) -> tuple:
    """The per-image draws of op ``name`` for ``n`` images of x's shape
    (x's own count by default)."""
    n = x.shape[0] if n is None else n
    dev = x.device
    if name == "brightness":
        return (_uniform(n, -0.5, 0.5, generator, dev),)
    if name == "saturation":
        return (_uniform(n, 0.0, 2.0, generator, dev),)
    if name == "contrast":
        return (_uniform(n, 0.5, 1.5, generator, dev),)
    if name == "color":
        return tuple(d for op in ("brightness", "saturation", "contrast")
                     for d in draw(op, x, generator, n))
    if name == "translation":
        sh, sw = _shift(x, 0.125)
        return (torch.randint(-sh, sh + 1, (n,), generator=generator,
                              device=dev),
                torch.randint(-sw, sw + 1, (n,), generator=generator,
                              device=dev))
    if name == "cutout":
        # the paper places the centre uniformly
        ch, cw = _shift(x, 0.5)
        h, w = x.shape[2:]
        return (torch.randint(-(ch // 2), h - ch + ch // 2 + 1, (n,),
                              generator=generator, device=dev),
                torch.randint(-(cw // 2), w - cw + cw // 2 + 1, (n,),
                              generator=generator, device=dev))
    raise ValueError(f"unknown diff_augment op {name!r}")


_OPS = {"color": color, "translation": translation, "cutout": cutout,
        "brightness": brightness, "saturation": saturation,
        "contrast": contrast}


def parse_policy(policy: str):
    """Validate a comma-separated op list; returns the op names."""
    names = [p.strip() for p in str(policy).split(",") if p.strip()]
    unknown = [p for p in names if p not in _OPS]
    if unknown:
        raise ValueError(f"unknown diff_augment op(s) {unknown}; "
                         f"available: {sorted(_OPS)}")
    return names


def augment(x, policy: str, generator=None, n: int | None = None):
    """Apply the policy's ops in order, each with fresh draws.  With ``n``,
    x holds this rank's rows of a global batch of ``n`` images: the draws
    are made for all ``n`` and each rank keeps its rows
    (``parallel.mesh.local_slice``), as one process would draw them."""
    for name in parse_policy(policy):
        d = draw(name, x, generator, n)
        if n is not None and n != x.shape[0]:
            d = tuple(mesh.local_slice(t) for t in d)
        x = _OPS[name](x, *d)
    return x

"""Image quality metrics (port of
``msra_practice_project_tpu/core/metrics.py``): PSNR, the float64 host SSIM
and MS-SSIM, LPIPS when weights are given, and the random-conv feature
distance.

Images are numpy arrays or tensors (tensors are moved to the host, except
for the convolutional metrics, which run on the tensor's device).

  * PSNR is ``-10*log10(mse)``, as the reference computes it inline
    (nerf/train_nerf.py:160, nerf/test_nerf.py:107).
  * SSIM follows the vendored Gaussian-window implementation
    (nerf/pytorch_ssim/__init__.py:7-73): 11x11 window, sigma 1.5, zero
    padding, per-channel convolution, C1=0.01^2, C2=0.03^2, in float64.
  * LPIPS needs pretrained AlexNet weights, which are never downloaded:
    ``lpips()`` returns None unless a weights directory is given.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from .image_io import _numpy


def mse(a, b):
    return float(np.mean((_numpy(a).astype(np.float64)
                          - _numpy(b).astype(np.float64)) ** 2))


def psnr(a, b=None, *, mse_value=None):
    """-10*log10(mse).  Pass two images, or a precomputed mse."""
    if b is None and mse_value is None:
        raise TypeError("psnr needs two images or mse_value=...")
    m = mse(a, b) if mse_value is None else float(mse_value)
    return -10.0 * math.log10(m)


def _to_nchw64(img):
    x = _numpy(img).astype(np.float64)
    if x.ndim == 3:  # HWC -> NCHW
        x = np.transpose(x, (2, 0, 1))[None]
    return x


def _ssim_and_cs_maps(img1, img2, window_size: int):
    """Per-pixel SSIM map and contrast-structure (cs) map, NCHW float64."""
    g = np.array(
        [math.exp(-((x - window_size // 2) ** 2) / (2.0 * 1.5**2))
         for x in range(window_size)], dtype=np.float64)
    g /= g.sum()

    from scipy.ndimage import convolve1d

    def conv(x):
        # zero-padded depthwise conv, as F.conv2d(padding=K//2); the window
        # is separable (outer(g, g)), so two 1-D passes over [N, C]
        out = convolve1d(x, g, axis=-1, mode="constant")
        return convolve1d(out, g, axis=-2, mode="constant")

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2

    c1, c2 = 0.01**2, 0.03**2
    lum = (2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)
    cs = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    return lum * cs, cs


def ssim(img1, img2, window_size: int = 11, size_average: bool = True):
    """SSIM over NCHW images (matches nerf/pytorch_ssim/__init__.py:17-37).

    Accepts [N, C, H, W] or [H, W, C].  Computed on the host in float64: the
    variance form conv(x^2) - mu^2 cancels catastrophically in fp32 on
    smooth or near-identical images (values can exceed 1)."""
    img1, img2 = _to_nchw64(img1), _to_nchw64(img2)
    ssim_map, _ = _ssim_and_cs_maps(img1, img2, window_size)
    if size_average:
        return float(np.mean(ssim_map))
    return np.mean(ssim_map, axis=(1, 2, 3))


MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(img1, img2, window_size: int = 11):
    """Multi-scale SSIM (Wang, Simoncelli & Bovik 2003).

    Standard 5-scale exponents; the scale count adapts downward so the
    coarsest scale still covers the 11x11 window (exponents renormalised).
    Downsampling is 2x2 average pooling, as in the original.
    """
    a, b = _to_nchw64(img1), _to_nchw64(img2)

    levels = 1
    while (levels < len(MS_SSIM_WEIGHTS)
           and min(a.shape[-2:]) // 2**levels >= window_size):
        levels += 1
    w = np.array(MS_SSIM_WEIGHTS[:levels])
    w = w / w.sum()

    def pool2(x):
        h, wd = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
        x = x[..., :h, :wd]
        return x.reshape(*x.shape[:-2], h // 2, 2, wd // 2, 2).mean((-3, -1))

    vals = []
    for i in range(levels):
        ssim_map, cs_map = _ssim_and_cs_maps(a, b, window_size)
        if i < levels - 1:
            vals.append(np.mean(cs_map))
            a, b = pool2(a), pool2(b)
        else:
            vals.append(np.mean(ssim_map))
    vals = np.clip(np.array(vals), 1e-6, None)  # guard negative ** fraction
    return float(np.prod(vals**w))


def perceptual_distance(img1, img2, weights_dir: str | None = None):
    """(distance, provenance): LPIPS(alex) when pretrained weights exist,
    else ``1 - MS-SSIM``, labelled as such (not LPIPS, but a deterministic
    perceptual distance that needs no weights).  Lower is better."""
    lp = lpips(img1, img2, weights_dir)
    if lp is not None:
        return lp, "lpips-alex"
    return 1.0 - ms_ssim(img1, img2), "1-msssim"


_lpips_cache: dict = {}


def lpips(img1, img2, weights_dir: str | None = None):
    """LPIPS(alex) as nerf/test_nerf.py:80,109 uses it.

    ``weights_dir`` must hold ``alexnet.pth`` (a torchvision state_dict) and
    ``lpips_lin.pth`` (the LPIPS v0.1 linear heads).  Without them returns
    None and callers record null."""
    if weights_dir is None or not os.path.isdir(weights_dir):
        return None
    if weights_dir not in _lpips_cache:
        from .lpips import LPIPS
        _lpips_cache[weights_dir] = LPIPS.from_torch_checkpoint(
            os.path.join(weights_dir, "alexnet.pth"),
            os.path.join(weights_dir, "lpips_lin.pth"))
    return float(_lpips_cache[weights_dir](img1, img2))


# ---------------------------------------------------------------------------
# Feature-space distribution distance (random-conv Frechet)
# ---------------------------------------------------------------------------

_rf_params_cache: dict = {}


def _random_feature_params(seed: int = 0, width: int = 64, depth: int = 3):
    """A fixed random conv stack (seeded; the same draws as the JAX
    package's): the untrained-feature embedding of ``feature_distance``, a
    weight-free stand-in for Inception features."""
    key = (seed, width, depth)
    if key not in _rf_params_cache:
        rng = np.random.default_rng(seed)
        params = []
        in_ch = 3
        for _ in range(depth):
            w = rng.normal(size=(width, in_ch, 3, 3)).astype(np.float32)
            w /= np.sqrt(in_ch * 9)
            params.append(torch.from_numpy(w))
            in_ch = width
        _rf_params_cache[key] = params
    return _rf_params_cache[key]


@torch.no_grad()
def _rf_embed(imgs, params):
    """imgs [N, H, W, 3] in [0,1] -> [N, 2*width] (global mean and std pool
    of the last conv layer's activations), on the images' device."""
    h = torch.as_tensor(imgs, dtype=torch.float32).permute(0, 3, 1, 2) * 2 - 1
    for w in params:
        h = F.leaky_relu(F.conv2d(h, w.to(h.device), stride=2, padding=1),
                         0.2)
    return torch.cat([h.mean(dim=(2, 3)), h.std(dim=(2, 3), correction=0)],
                     dim=1)


def frechet_from_features(fa, fb):
    """Frechet distance (diagonal covariance) between two feature sets
    [N, F].  Lower is better; 0 iff the per-feature means and variances
    match."""
    fa = _numpy(fa).astype(np.float64)
    fb = _numpy(fb).astype(np.float64)
    mu_a, mu_b = fa.mean(0), fb.mean(0)
    var_a, var_b = fa.var(0), fb.var(0)
    return float(((mu_a - mu_b) ** 2).sum()
                 + ((np.sqrt(var_a) - np.sqrt(var_b)) ** 2).sum())


def feature_distance(imgs_a, imgs_b, seed: int = 0):
    """Frechet distance (diagonal covariance) between two image sets in a
    fixed random-conv feature space: a weight-free stand-in for FID.
    imgs [N, H, W, 3] in [0,1]; both sets share H, W.  Lower is better."""
    params = _random_feature_params(seed)
    return frechet_from_features(_rf_embed(imgs_a, params),
                                 _rf_embed(imgs_b, params))

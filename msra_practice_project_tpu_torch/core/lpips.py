"""LPIPS perceptual metric with an AlexNet backbone (port of
``msra_practice_project_tpu/core/lpips.py``).

The reference computes LPIPS through the pip ``lpips`` package, whose
pretrained AlexNet weights it downloads at first use
(nerf/test_nerf.py:11,80,109).  Nothing is downloaded here: the metric
(feature extractor, unit normalisation, linear heads, spatial average: the
LPIPS v0.1 definition) runs when local weight files are supplied:

    lp = LPIPS.from_torch_checkpoint("alexnet.pth", "lpips_lin.pth")
    score = lp(img1, img2)   # [H, W, 3] or [N, 3, H, W] in [0, 1]

Without weights ``core.metrics.lpips`` returns None and the eval scripts
record null.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# AlexNet feature config: (out_ch, kernel, stride, padding) per conv layer,
# with max-pools where torchvision.models.alexnet.features has them.
_ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
# torchvision .features indices of the conv weights
_TV_IDX = [0, 3, 6, 8, 10]
# max-pool after conv 0 and 1 (and 4, but LPIPS taps activations before it)
_POOL_AFTER = {0, 1}

# LPIPS input normalisation (the "scaling layer")
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS(nn.Module):
    """``convs.{i}``: the five AlexNet convolutions; ``lins.{i}.weight``:
    the five ``[1, C, 1, 1]`` linear heads."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList()
        in_ch = 3
        for out_ch, k, stride, pad in _ALEX_CONVS:
            self.convs.append(nn.Conv2d(in_ch, out_ch, k, stride, pad))
            in_ch = out_ch
        self.lins = nn.ModuleList(
            nn.Conv2d(out_ch, 1, 1, bias=False) for out_ch, *_ in _ALEX_CONVS)
        self.register_buffer("shift", torch.from_numpy(_SHIFT)[:, None, None],
                             persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE)[:, None, None],
                             persistent=False)
        self.requires_grad_(False)

    # -- weight loading ----------------------------------------------------
    @classmethod
    def from_torch_checkpoint(cls, alexnet_path: str, lin_path: str):
        """alexnet_path: a torchvision alexnet state_dict (.pth); lin_path:
        an lpips 0.1 linear-head state_dict (``lin0.model.1.weight``...).
        Local files only."""
        alex = torch.load(alexnet_path, map_location="cpu",
                          weights_only=True)
        lin = torch.load(lin_path, map_location="cpu", weights_only=True)
        state = {}
        for j, i in enumerate(_TV_IDX):
            state[f"convs.{j}.weight"] = alex[f"features.{i}.weight"]
            state[f"convs.{j}.bias"] = alex[f"features.{i}.bias"]
        for i in range(5):
            for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
                if k in lin:
                    state[f"lins.{i}.weight"] = lin[k]
                    break
            else:
                raise ValueError("unrecognised lpips linear-head checkpoint")
        model = cls()
        model.load_state_dict(state)
        return model

    @classmethod
    def random_init(cls, generator: torch.Generator | None = None,
                    seed_scale: float = 0.1):
        """Random weights: NOT a calibrated perceptual metric; for tests and
        as an untrained-feature distance only."""
        model = cls()
        for conv, (_, k, _, _) in zip(model.convs, _ALEX_CONVS):
            in_ch = conv.in_channels
            conv.weight.copy_(torch.randn(conv.weight.shape,
                                          generator=generator)
                              * seed_scale / np.sqrt(in_ch * k * k))
            conv.bias.zero_()
        for lin in model.lins:
            lin.weight.copy_(torch.randn(lin.weight.shape,
                                         generator=generator).abs() * 0.01)
        return model

    # -- forward -----------------------------------------------------------
    def features(self, x):
        """x [N, 3, H, W] in [0, 1] -> list of 5 activation maps."""
        h = (2.0 * x - 1.0 - self.shift) / self.scale  # lpips expects [-1, 1]
        feats = []
        for i, conv in enumerate(self.convs):
            h = F.relu(conv(h))
            feats.append(h)
            if i in _POOL_AFTER:
                h = F.max_pool2d(h, 3, 2)
        return feats

    @torch.no_grad()
    def forward(self, img1, img2):
        dev = self.shift.device
        img1, img2 = _to_nchw(img1, dev), _to_nchw(img2, dev)
        total = 0.0
        for a, b, lin in zip(self.features(img1), self.features(img2),
                             self.lins):
            a = a / (torch.linalg.norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.norm(b, dim=1, keepdim=True) + 1e-10)
            # 1x1 conv head, then the spatial average
            total = total + lin((a - b) ** 2).mean(dim=(1, 2, 3))
        return total if total.shape[0] > 1 else total[0]


def _to_nchw(img, device):
    img = torch.as_tensor(img, dtype=torch.float32, device=device)
    if img.ndim == 3:  # HWC
        img = img.permute(2, 0, 1)[None]
    return img

"""NeRF and SirenNeRF radiance-field MLPs (port of
``msra_practice_project_tpu/models/nerf.py``).

``forward(x[..., 6]) -> [..., 4]``: the input packs (position, view
direction), the output (rgb in [0,1], sigma >= 0).  8x256 trunk with the
embedded position skip-concatenated at layer 5 in the order ``[e_pos, h]``,
a ReLU sigma head, and a view-dir branch in the order ``[h, e_dir]``
256 -> 128 -> rgb sigmoid (ref: nerf/nerf.py:58-94).  SirenNeRF
(``use_siren=True``, ref: nerf/nerf.py:120-170) swaps sine layers in, drops
the PEs and skips the raw position: ``[pos, h]`` into layer 5 and
``[h, direction]`` into the direction branch's sine layer.  Parameter names
follow the JAX param tree (``layers_pos``, ``layers_dir``, ``sigma``,
``rgb``).  The SirenNeRF runs as plain PyTorch on either device: the fused
kernels serve the PE model only, as the JAX package's Pallas kernel does.

Which forwards take a kernel: ``forward`` of the PE model at the default
widths on a CUDA float32 input that autograd does not record (grad
disabled, or neither the input nor a parameter requires grad: the view
renders of the eval scripts, the trainer's preview and the benchmark) runs
``ops/kernels/nerf_mlp.nerf_forward_tf32``, one fused fp32 kernel (3xTF32
products on the tensor cores, within 1e-4 of max|ref| of the plain forward).
Every other call (the CPU, a forward that records a graph, the SirenNeRF,
other widths) runs ``forward_plain``.  The train step's fused route is
``fused_nerf_apply``, which the trainer calls itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core.nn import (dense_init, positional_encoding,
                       positional_encoding_dim, siren_apply, siren_init)
from ..ops.kernels import nerf_mlp as nerf_kernels


@dataclass(frozen=True)
class NeRFConfig:
    hidden_dim: int = 256
    use_siren: bool = False
    pe_pos_length: int = 10
    pe_dir_length: int = 4


class NeRFModel(nn.Module):
    def __init__(self, cfg: NeRFConfig = NeRFConfig(), *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim

        def dense(i, o, act):
            return dense_init(i, o, act, generator, device)

        if cfg.use_siren:
            def sine(i, o, scheme="nerf"):
                return siren_init(i, o, scheme, generator, device)
            self.layers_pos = nn.ModuleList(
                [sine(3, h, "nerf_first")] + [sine(h, h) for _ in range(4)]
                + [sine(h + 3, h)] + [sine(h, h) for _ in range(2)])
            self.layers_dir = nn.ModuleList(
                [dense(h, h, "linear"), sine(h + 3, h // 2)])
        else:
            pos_in = positional_encoding_dim(3, cfg.pe_pos_length)  # 60
            dir_pe = positional_encoding_dim(3, cfg.pe_dir_length)  # 24
            self.layers_pos = nn.ModuleList(
                [dense(pos_in, h, "relu")]
                + [dense(h, h, "relu") for _ in range(4)]
                + [dense(h + pos_in, h, "relu")]
                + [dense(h, h, "relu") for _ in range(2)])
            self.layers_dir = nn.ModuleList(
                [dense(h, h, "linear"), dense(h + dir_pe, h // 2, "relu")])
        self.sigma = dense(h, 1, "relu")
        self.rgb = dense(h // 2, 3, "sigmoid")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.use_siren:
            return self._siren_forward(x)
        if nerf_kernels.takes_tf32_kernel(self, x):
            return nerf_kernels.nerf_forward_tf32(self, x)
        return self.forward_plain(x)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The PE model's forward in plain PyTorch, on either device."""
        cfg = self.cfg
        pos, direction = x[..., :3], x[..., 3:6]
        e_pos = positional_encoding(pos, cfg.pe_pos_length)
        e_dir = positional_encoding(direction, cfg.pe_dir_length)
        lp = self.layers_pos
        h = torch.relu(lp[0](e_pos))
        for layer in lp[1:5]:
            h = torch.relu(layer(h))
        h = torch.cat([e_pos, h], dim=-1)
        for layer in lp[5:8]:
            h = torch.relu(layer(h))
        sigma = torch.relu(self.sigma(h))
        h = self.layers_dir[0](h)
        h = torch.cat([h, e_dir], dim=-1)
        h = torch.relu(self.layers_dir[1](h))
        rgb = torch.sigmoid(self.rgb(h))
        return torch.cat([rgb, sigma], dim=-1)

    def _siren_forward(self, x: torch.Tensor) -> torch.Tensor:
        pos, direction = x[..., :3], x[..., 3:6]
        lp = self.layers_pos
        h = siren_apply(lp[0], pos)
        for layer in lp[1:5]:
            h = siren_apply(layer, h)
        h = torch.cat([pos, h], dim=-1)
        for layer in lp[5:8]:
            h = siren_apply(layer, h)
        sigma = torch.relu(self.sigma(h))
        h = self.layers_dir[0](h)
        h = torch.cat([h, direction], dim=-1)
        h = siren_apply(self.layers_dir[1], h)
        rgb = torch.sigmoid(self.rgb(h))
        return torch.cat([rgb, sigma], dim=-1)


def nerf_model(use_siren: bool = False, *,
               generator: torch.Generator | None = None,
               device=None) -> NeRFModel:
    """Factory matching the `use_siren` config switch."""
    return NeRFModel(NeRFConfig(use_siren=use_siren), generator=generator,
                     device=device)

"""NeRF radiance-field MLP, PE variant (port of
``msra_practice_project_tpu/models/nerf.py``).

``forward(x[..., 6]) -> [..., 4]``: the input packs (position, view
direction), the output (rgb in [0,1], sigma >= 0).  8x256 trunk with the
embedded position skip-concatenated at layer 5 in the order ``[e_pos, h]``,
a ReLU sigma head, and a view-dir branch in the order ``[h, e_dir]``
256 -> 128 -> rgb sigmoid (ref: nerf/nerf.py:58-94).  Parameter names follow
the JAX param tree (``layers_pos``, ``layers_dir``, ``sigma``, ``rgb``).

SirenNeRF (``use_siren=True``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core.nn import dense_init, positional_encoding, positional_encoding_dim


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
        if cfg.use_siren:
            raise NotImplementedError(
                "SirenNeRF is not ported yet; use the PE NeRF")
        self.cfg = cfg
        h = cfg.hidden_dim
        pos_in = positional_encoding_dim(3, cfg.pe_pos_length)  # 60
        dir_pe = positional_encoding_dim(3, cfg.pe_dir_length)  # 24

        def dense(i, o, act):
            return dense_init(i, o, act, generator, device)

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


def nerf_model(use_siren: bool = False, *,
               generator: torch.Generator | None = None,
               device=None) -> NeRFModel:
    """Factory matching the `use_siren` config switch."""
    return NeRFModel(NeRFConfig(use_siren=use_siren), generator=generator,
                     device=device)

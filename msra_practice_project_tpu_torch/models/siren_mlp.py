"""Implicit-representation MLPs: SIREN / Tanh / ReLU / ReLU+PE (port of
``msra_practice_project_tpu/models/siren_mlp.py``; ref:
siren/modules.py:74-172).

Module names follow the JAX param tree (``input``, ``hidden.{i}``,
``output``), so ``weights.state_dict_from_params`` carries JAX parameters
over as they are.  On either device the MLP runs as plain PyTorch: the JAX
package runs it as plain XLA, with no Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core.nn import (dense_init, positional_encoding,
                       positional_encoding_dim, siren_apply, siren_init)

KINDS = ("siren", "tanh", "relu", "relu_pe")


@dataclass(frozen=True)
class MLPConfig:
    input_dim: int
    output_dim: int
    hidden_dim: int = 256
    hidden_layers: int = 3
    kind: str = "siren"  # siren | tanh | relu | relu_pe
    pe_length: int = 10  # only for relu_pe (ref: siren/modules.py:138)


class ImplicitMLP(nn.Module):
    """f: R^in -> R^out in one of the four kinds.

    SIREN init (ref: siren/modules.py:79-86): first layer U(+-1/in) weight,
    torch-default bias; hidden U(+-sqrt(6/h)/30) weight, torch-default bias;
    output U(+-sqrt(6/h)/30) weight, zero bias; w0 = 30.  The other kinds:
    Xavier-uniform with the activation's gain and a linear output layer.
    Layers are drawn from ``generator`` in order: input, hidden, output.
    """

    def __init__(self, cfg: MLPConfig, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if cfg.kind not in KINDS:
            raise ValueError(f"unknown model kind '{cfg.kind}' (have {KINDS})")
        self.cfg = cfg
        h = cfg.hidden_dim
        in_dim = cfg.input_dim
        if cfg.kind == "relu_pe":
            in_dim = positional_encoding_dim(cfg.input_dim, cfg.pe_length)
        if cfg.kind == "siren":
            def layer(i, o, scheme):
                return siren_init(i, o, scheme, generator, device)
            self.input = layer(in_dim, h, "first")
            self.hidden = nn.ModuleList(
                [layer(h, h, "hidden") for _ in range(cfg.hidden_layers)])
            self.output = layer(h, cfg.output_dim, "nerf")
        else:
            act = "tanh" if cfg.kind == "tanh" else "relu"

            def layer(i, o, a):
                return dense_init(i, o, a, generator, device)
            self.input = layer(in_dim, h, act)
            self.hidden = nn.ModuleList(
                [layer(h, h, act) for _ in range(cfg.hidden_layers)])
            self.output = layer(h, cfg.output_dim, "linear")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kind = self.cfg.kind
        if kind == "relu_pe":
            x = positional_encoding(x, self.cfg.pe_length)
        if kind == "siren":
            h = siren_apply(self.input, x)
            for layer in self.hidden:
                h = siren_apply(layer, h)
        else:
            act = torch.tanh if kind == "tanh" else torch.relu
            h = act(self.input(x))
            for layer in self.hidden:
                h = act(layer(h))
        return self.output(h)


def img_model(model_type: str, *, generator: torch.Generator | None = None,
              device=None) -> ImplicitMLP:
    """f(x, y) -> intensity (ref: siren/modules.py:154-162)."""
    return ImplicitMLP(MLPConfig(2, 1, 256, 3, kind=model_type),
                       generator=generator, device=device)


def sdf_model(model_type: str, *, generator: torch.Generator | None = None,
              device=None) -> ImplicitMLP:
    """f(x, y, z) -> signed distance (ref: siren/modules.py:164-172)."""
    return ImplicitMLP(MLPConfig(3, 1, 256, 3, kind=model_type),
                       generator=generator, device=device)

"""Weight bridge: the JAX package's NeRF param tree -> the port's
``state_dict``.

The JAX tree is nested dicts/tuples of numpy arrays
(``{"layers_pos": ({"w", "b"}, ...), "layers_dir": (...), "sigma": {...},
"rgb": {...}}``) with weights stored ``[in, out]``; ``nn.Linear`` stores
``[out, in]``, so each weight is transposed.
"""

from __future__ import annotations

import numpy as np
import torch


def _linear(prefix: str, p: dict, out: dict) -> None:
    out[f"{prefix}.weight"] = torch.from_numpy(
        np.array(p["w"], np.float32).T.copy())
    out[f"{prefix}.bias"] = torch.from_numpy(
        np.array(p["b"], np.float32))


def nerf_state_dict(params) -> dict:
    """JAX NeRF params (numpy leaves) -> ``NeRFModel`` state_dict."""
    out: dict = {}
    for group in ("layers_pos", "layers_dir"):
        for i, p in enumerate(params[group]):
            _linear(f"{group}.{i}", p, out)
    _linear("sigma", params["sigma"], out)
    _linear("rgb", params["rgb"], out)
    return out


def nerf_params_from_state_dict(state: dict) -> dict:
    """The inverse: ``NeRFModel`` state_dict -> JAX-layout numpy tree."""
    def lin(prefix):
        return {"w": state[f"{prefix}.weight"].detach().cpu().numpy().T.copy(),
                "b": state[f"{prefix}.bias"].detach().cpu().numpy().copy()}

    def group(name):
        n = 1 + max(int(k.split(".")[1]) for k in state
                    if k.startswith(name + "."))
        return tuple(lin(f"{name}.{i}") for i in range(n))

    return {"layers_pos": group("layers_pos"),
            "layers_dir": group("layers_dir"),
            "sigma": lin("sigma"), "rgb": lin("rgb")}

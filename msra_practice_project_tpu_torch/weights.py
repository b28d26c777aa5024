"""Weight bridge between the JAX package's param trees and the port's
``state_dict``s, in both directions.

A JAX tree is nested dicts/tuples of arrays whose layers are ``{"w", "b"}``
dicts; the port's module names join the same keys and tuple indices with
dots, ``w`` becoming ``weight`` and ``b`` ``bias`` (the NeRF's
``layers_pos.3.weight``, pi-GAN's ``mapping.heads.8.bias``,
``trunk.hidden.0.weight``, ``blocks.2.conv1.weight``).  Linear weights are
``[in, out]`` in JAX and ``[out, in]`` in ``nn.Linear``, so they are
transposed; convolution weights are OIHW in both and are not.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {"w": "weight", "b": "bias"}
_KEY = {v: k for k, v in _LEAF.items()}


def _to_port(name: str, a) -> torch.Tensor:
    a = np.array(a, np.float32)
    if name == "weight" and a.ndim == 2:
        a = a.T
    return torch.from_numpy(np.ascontiguousarray(a))


def state_dict_from_params(params) -> dict:
    """JAX param tree (numpy or jax leaves) -> the port's ``state_dict``."""
    out: dict = {}

    def walk(prefix, node):
        items = (node.items() if isinstance(node, dict)
                 else enumerate(node))
        for k, v in items:
            if isinstance(v, (dict, tuple, list)):
                walk(f"{prefix}{k}.", v)
            else:
                out[f"{prefix}{_LEAF[k]}"] = _to_port(_LEAF[k], v)

    walk("", params)
    return out


def params_from_state_dict(state: dict) -> dict:
    """The inverse: a ``state_dict`` -> the JAX-layout numpy tree (numbered
    children become tuples)."""
    root: dict = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        a = t.detach().cpu().numpy().copy()
        node[_KEY[leaf]] = a.T.copy() if leaf == "weight" and a.ndim == 2 \
            else a

    def freeze(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return tuple(freeze(node[str(i)]) for i in range(len(node)))
        return {k: freeze(v) for k, v in node.items()}

    return freeze(root)


def lpips_state_dict_from_params(params) -> dict:
    """The JAX package's LPIPS params (``{"convs": [(w, b)] * 5, "lins":
    [w] * 5}``, OIHW) -> the ``state_dict`` of the port's ``core.lpips.LPIPS``
    (``convs.{i}.weight``/``bias``, ``lins.{i}.weight``)."""
    out = {}
    for i, (w, b) in enumerate(params["convs"]):
        out[f"convs.{i}.weight"] = _to_port("weight", w)
        out[f"convs.{i}.bias"] = _to_port("bias", b)
    for i, w in enumerate(params["lins"]):
        out[f"lins.{i}.weight"] = _to_port("weight", w)
    return out

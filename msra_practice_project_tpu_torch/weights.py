"""Weight bridge between the JAX package's param trees and the port's
``state_dict``s, in both directions.

A JAX tree is nested dicts/tuples of arrays whose layers are ``{"w", "b"}``
dicts; the port's module names join the same keys and tuple indices with
dots, ``w`` becoming ``weight`` and ``b`` ``bias`` (the NeRF's and the
SirenNeRF's ``layers_pos.3.weight``, pi-GAN's ``mapping.heads.8.bias``,
``trunk.hidden.0.weight``, ``blocks.2.conv1.weight``, the implicit MLP's
``input.weight``, ``hidden.2.bias`` and ``output.weight``).  Linear weights are
``[in, out]`` in JAX and ``[out, in]`` in ``nn.Linear``, so they are
transposed; convolution weights are OIHW in both and are not.

``train_state_from_jax`` turns a whole train state the JAX package
checkpointed (``core/ckpt.restore`` of its msgpack file) into the port's
checkpoint layout, Adam's moments and count included; ``restore_state``
does so for any restored checkpoint that needs it (the trainers' resume and
the eval loaders).
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {"w": "weight", "b": "bias"}
_KEY = {v: k for k, v in _LEAF.items()}


def _to_port(name: str, a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a.detach().to(torch.float32)
    else:
        t = torch.from_numpy(np.array(a, np.float32))
    if name == "weight" and t.ndim == 2:
        t = t.T
    return t.contiguous()


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


def is_jax_train_state(tree) -> bool:
    """Whether a restored checkpoint is a JAX train state (optax's
    ``opt_state`` beside the params) rather than the port's layout."""
    if not isinstance(tree, dict):
        return False
    g = tree.get("g")
    return "opt_state" in tree or (isinstance(g, dict) and "opt_state" in g)


def _adam_from_jax(opt_state, mu_nu_of) -> dict:
    """optax's ``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(
    count))`` -> ``{"count", "exp_avg", "exp_avg_sq"}`` with the moments as
    ``{model name: state_dict}`` (``common.load_adam``'s named form).
    ``mu_nu_of`` maps a moment tree to ``{model name: JAX tree}``.

    The two updates agree: optax divides the bias-corrected first moment by
    ``sqrt(nu_hat) + eps`` (eps outside the root, ``eps_root`` 0), as
    ``torch.optim.Adam`` does, and its ``count`` is the updates applied,
    torch's per-parameter ``step``."""
    adam, sched = opt_state["0"], opt_state["1"]
    count = int(adam["count"])
    if int(sched["count"]) != count:
        raise ValueError(f"Adam count {count} and schedule count "
                         f"{int(sched['count'])} disagree")
    out = {"count": count}
    for key, moment in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        out[key] = {name: state_dict_from_params(tree)
                    for name, tree in mu_nu_of(adam[moment]).items()
                    if tree is not None}
    return out


def train_state_from_jax(tree, kind: str) -> dict:
    """A JAX train state -> the port's checkpoint layout, for the trainer
    ``kind``:
      * "nerf": ``{"params": {"coarse", "fine"}, "opt_state", "step"}``
        -> ``{"models": {"coarse", "fine"}, "opt", "step"}`` ("fine" only
        with a fine model);
      * "img", "sdf": ``{"params", "opt_state", "step"}`` ->
        ``{"models": {"model"}, "opt", "step"}``;
      * "pigan": ``{"g": state, "d": state, "step"}`` -> ``{"g", "d",
        "g_opt", "d_opt", "step"}``.
    Models are ``state_dict``s; "opt" entries are ``common.load_adam``'s
    named form."""
    if kind == "nerf":
        def split(t):
            return {k: v for k, v in t.items() if v is not None}
    elif kind in ("img", "sdf"):
        def split(t):
            return {"model": t}
    elif kind == "pigan":
        out = {"step": int(tree["step"])}
        for name in ("g", "d"):
            out[name] = state_dict_from_params(tree[name]["params"])
            out[f"{name}_opt"] = _adam_from_jax(
                tree[name]["opt_state"], lambda t, n=name: {n: t})
        return out
    else:
        raise ValueError(f"unknown train state kind {kind!r}")
    return {"models": {k: state_dict_from_params(v)
                       for k, v in split(tree["params"]).items()},
            "opt": _adam_from_jax(tree["opt_state"], split),
            "step": int(tree["step"])}


def restore_state(saved, kind: str | None) -> dict:
    """A restored checkpoint in the port's layout: a JAX train state is
    converted for the trainer ``kind`` (``train_state_from_jax``), the
    port's own is returned as it is."""
    if not is_jax_train_state(saved):
        return saved
    if kind is None:
        raise ValueError("a JAX checkpoint needs the trainer kind to load")
    return train_state_from_jax(saved, kind)

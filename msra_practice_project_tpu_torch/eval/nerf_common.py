"""Shared helpers of the NeRF eval scripts (port of
``msra_practice_project_tpu/eval/nerf_common.py``): reload an experiment
and render one view.

Renders use the plain models (``NeRFModel.forward``), as the JAX eval path
does: the fused kernels serve the train step only.  Rendering runs on one
device; the JAX package's sharded render over a multi-chip mesh waits for
the port's ``torch.distributed`` work.
"""

from __future__ import annotations

import os

import torch

from .. import resolve_device, set_plain_precision
from ..core import ckpt as ckpt_lib
from ..core.config import NERF_TRAIN_DEFAULTS, load_config, resolve
from ..models.nerf import nerf_model
from ..ops.render import render_image


def load_experiment(log_path: str, ckpt_idx: int | None = None,
                    device=None):
    """Re-read the resolved config written at train time
    (ref: nerf/test_nerf.py:16-21), rebuild both models and restore the
    requested checkpoint (the newest readable one when ``ckpt_idx`` is
    None).  Returns (config, (coarse_model, fine_model), checkpoint, step);
    ``fine_model`` is None without ``use_fine_model``.  Runs on CUDA unless
    ``device='cpu'``."""
    device = resolve_device(device)
    set_plain_precision()
    config = resolve(load_config(os.path.join(log_path, "config.json")),
                     NERF_TRAIN_DEFAULTS)
    if ckpt_idx is not None:
        step = ckpt_idx
        state = ckpt_lib.restore(ckpt_lib.ckpt_path(log_path, ckpt_idx),
                                 map_location=device)
    else:
        found = ckpt_lib.restore_latest(log_path, map_location=device)
        if found is None:
            raise FileNotFoundError(f"no checkpoint under {log_path}")
        step, state = found
    models = []
    for name in ("coarse", "fine"):
        if name == "fine" and not config["use_fine_model"]:
            models.append(None)
            continue
        m = nerf_model(config["use_siren"], device=device)
        m.load_state_dict(state["models"][name])
        models.append(m.eval())
    return config, tuple(models), state, step


def model_fns(config, models):
    """(coarse_fn, fine_fn): the plain models; the coarse one serves both
    passes without ``use_fine_model``."""
    coarse_model, fine_model = models
    return coarse_model, (fine_model if config["use_fine_model"]
                          else coarse_model)


def generator_for(models, seed: int = 0) -> torch.Generator:
    """A generator on the models' device, seeded: the stratified draws of
    one eval run, view after view."""
    dev = next(models[0].parameters()).device
    return torch.Generator(device=dev).manual_seed(seed)


def render_view(config, models, width, height, focal, pose,
                generator: torch.Generator | None = None,
                sample_mult: float = 1.0, chunk: int = 16384):
    """Render one full frame on the models' device; ``generator`` (on that
    device) draws the stratified jitter.  Returns numpy (rgb ``[H,W,3]``,
    depth and acc ``[H,W,1]``)."""
    coarse_fn, fine_fn = model_fns(config, models)
    nc = int(sample_mult * config["render_coarse_sample_num"])
    nf = int(sample_mult * config["render_fine_sample_num"])
    device = next(coarse_fn.parameters()).device
    rgb, depth, acc = render_image(
        width, height, focal, pose, config["render_near"],
        config["render_far"], coarse_fn, fine_fn, nc, nf, chunk=chunk,
        generator=generator, device=device)
    return rgb.cpu().numpy(), depth.cpu().numpy(), acc.cpu().numpy()


def split_device_flag(argv):
    """(argv without ``--device X``, X or None)."""
    argv = list(argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    return argv, device

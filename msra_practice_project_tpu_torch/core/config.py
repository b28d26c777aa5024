"""Config system (port of ``msra_practice_project_tpu/core/config.py``).

The same JSON key names and defaults as the JAX package, so the 49 experiment
configs under ``msra_practice_project_tpu/configs/`` load verbatim; the files
are read in place (``CONFIG_ROOT``).  The resolved config is written back into
the log directory, as the reference does.
"""

from __future__ import annotations

import json
import os
from typing import Any

# The experiment configs live with the JAX package and are read in place.
CONFIG_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "msra_practice_project_tpu", "configs")


class Config(dict):
    """A dict with attribute access and defaulting `.get`."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        return Config(json.load(f))


def save_config(config: dict, log_path: str, name: str = "config.json") -> str:
    """Write the resolved config back into the experiment log directory."""
    os.makedirs(log_path, exist_ok=True)
    out = os.path.join(log_path, name)
    with open(out, "w") as f:
        json.dump(dict(config), f, indent=2)
    return out


def log_dir(config: dict) -> str:
    return os.path.join(config["output_path"], config["experiment_name"])


NERF_TRAIN_DEFAULTS = {
    # nerf/train_nerf.py:21-45
    "data_resize": 0.5,
    "data_skip": 8,
    "data_train_idx": None,
    "data_view_dir_range": None,
    "data_view_dir_noise": None,
    "data_target_num": None,
    "data_show_distribution": False,
    "render_near": 2.0,
    "render_far": 6.0,
    "render_coarse_sample_num": 64,
    "render_fine_sample_num": 128,
    "iterations": 200000,
    "batch_size": 1024,
    "learning_rate": 5e-4,
    "learning_rate_decay": 500,
    "start_up_itrs": 500,
    "use_fine_model": True,
    "use_alpha": False,
    "use_siren": False,
    # Route the MLP through the fused kernels (ops/kernels/nerf_mlp.py) when
    # training the PE NeRF on CUDA.
    "use_fused_mlp": True,
    # Read for config compatibility.  The JAX trainer scans this many steps
    # per XLA dispatch; the port runs one step per loop iteration, which is
    # the same math.
    "steps_per_call": 10,
    "i_print": 100,
    "i_save": 10000,
    "i_image": 1000,
}


def resolve(config: dict, defaults: dict) -> Config:
    """Fill in defaults for missing keys (does not mutate the input).  List
    defaults are copied so a consumer mutating its config cannot corrupt the
    module-level tables."""
    out = Config({k: (list(v) if isinstance(v, list) else v)
                  for k, v in defaults.items()})
    out.update(config)
    return out

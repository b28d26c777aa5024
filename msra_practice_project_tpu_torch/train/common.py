"""Shared trainer plumbing (port of
``msra_practice_project_tpu/train/common.py``): learning-rate schedule, Adam,
train state, resume and CLI.

Every driver is ``python -m msra_practice_project_tpu_torch.train.<name>
<config.json> [key=value ...]``.
"""

from __future__ import annotations

import json
import sys

import torch

from ..core import ckpt as ckpt_lib
from ..core.config import Config, load_config, resolve


def exponential_lr(base_lr: float, decay_thousands: float,
                   decay_rate: float = 0.1):
    """lr * rate^(step / (decay_thousands * 1000)) — the reference's manual
    per-step decay (nerf/train_nerf.py:170-176)."""
    def schedule(step):
        return base_lr * decay_rate ** (step / (decay_thousands * 1000.0))
    return schedule


class Adam:
    """``torch.optim.Adam`` (betas (0.9, 0.999), eps 1e-8) with a per-step
    learning rate ``schedule(count)``, where ``count`` is the number of
    updates applied before this one, as optax counts."""

    def __init__(self, params, schedule, betas=(0.9, 0.999)):
        self.schedule = schedule
        self.count = 0
        self.opt = torch.optim.Adam(params, lr=schedule(0), betas=betas,
                                    eps=1e-8)

    def step(self):
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])


def adam(params, learning_rate, betas=(0.9, 0.999)) -> Adam:
    """Adam over ``params``; a float lr is a constant schedule."""
    if not callable(learning_rate):
        lr_value = float(learning_rate)

        def learning_rate(step):  # noqa: F811 - constant schedule
            return lr_value
    return Adam(params, learning_rate, betas)


def init_state(models: dict, opt: Adam) -> dict:
    """The train state: the models, the optimizer and the step count."""
    return {"models": models, "opt": opt, "step": 0}


def state_dict(state: dict) -> dict:
    """What a checkpoint holds."""
    return {"models": {k: m.state_dict() for k, m in state["models"].items()},
            "opt": state["opt"].state_dict(), "step": state["step"]}


def resume(log_path: str, state: dict) -> tuple[int, dict]:
    """Scan-resume in place: returns (global_step, state); 0 and the fresh
    state when no checkpoint exists (ref: nerf/train_nerf.py:100-114)."""
    dev = next(next(iter(state["models"].values())).parameters()).device
    found = ckpt_lib.restore_latest(log_path, map_location=dev)
    if found is None:
        return 0, state
    step, saved = found
    for k, m in state["models"].items():
        m.load_state_dict(saved["models"][k])
    state["opt"].load_state_dict(saved["opt"])
    state["step"] = int(saved["step"])
    print(f"Reloading from {ckpt_lib.ckpt_path(log_path, step)}")
    return step, state


def parse_cli(argv, defaults: dict) -> Config:
    """argv = [config.json, k=v, ...] -> resolved Config."""
    if not argv:
        print("usage: ... <config.json> [key=value ...]", file=sys.stderr)
        raise SystemExit(2)
    cfg = resolve(load_config(argv[0]), defaults)
    for kv in argv[1:]:
        k, v = kv.split("=", 1)
        try:
            cfg[k] = json.loads(v)
        except json.JSONDecodeError:
            cfg[k] = v
    return cfg

"""Shared trainer plumbing (port of
``msra_practice_project_tpu/train/common.py``): learning-rate schedules,
Adam, train state, resume (from the port's checkpoints or the JAX
package's), the step profiler, parameter counts and CLI.

Every driver is ``python -m msra_practice_project_tpu_torch.train.<name>
<config.json> [key=value ...] [--device D] [--backend B]``; under
``torchrun`` it joins the process group first (``parallel/mesh.py``) and
trains data-parallel.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import torch

from .. import weights
from ..core import ckpt as ckpt_lib
from ..core.config import Config, load_config, resolve
from ..core.diagnostics import StepProfiler, span
from ..parallel import mesh


def fold_seed(seed: int, i: int) -> int:
    """The seed of element ``i`` of the stream seeded ``seed``: a pure
    function of both, so a resumed run draws what the uninterrupted run
    drew."""
    return seed * 1_000_003 + i


def exponential_lr(base_lr: float, decay_thousands: float,
                   decay_rate: float = 0.1):
    """lr * rate^(step / (decay_thousands * 1000)) — the reference's manual
    per-step decay (nerf/train_nerf.py:170-176)."""
    def schedule(step):
        return base_lr * decay_rate ** (step / (decay_thousands * 1000.0))
    return schedule


def interp_lr(lr0: float, lr_end: float, decay_thousands: float,
              decay_rate: float = 0.1):
    """lr_end + (lr0 - lr_end) * rate^(step / (decay_thousands * 1000)) —
    the pi-GAN dual decay (pi_GAN/train.py:138-147)."""
    def schedule(step):
        return lr_end + (lr0 - lr_end) * decay_rate ** (
            step / (decay_thousands * 1000.0))
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
        with span("adam"):
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


def load_adam(opt: Adam, saved: dict, models: dict) -> None:
    """Load an optimizer checkpoint into ``opt``: the port's own
    (``Adam.state_dict``) or the named form ``weights.train_state_from_jax``
    makes of a JAX one (``{"count", "exp_avg": {model name: state_dict},
    "exp_avg_sq": ...}``), whose names are those of ``models``' parameters.
    The count becomes the wrapper's ``count`` and torch's per-parameter
    ``step``."""
    if "exp_avg" not in saved:
        opt.load_state_dict(saved)
        return
    names = {id(p): (m, n) for m, module in models.items()
             for n, p in module.named_parameters()}
    count = int(saved["count"])
    for group in opt.opt.param_groups:
        for p in group["params"]:
            m, n = names[id(p)]
            opt.opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": saved["exp_avg"][m][n].to(p),
                "exp_avg_sq": saved["exp_avg_sq"][m][n].to(p)}
    opt.count = count


def resume(log_path: str, state: dict,
           kind: str | None = None) -> tuple[int, dict]:
    """Scan-resume in place: returns (global_step, state); 0 and the fresh
    state when no checkpoint exists (ref: nerf/train_nerf.py:100-114).
    ``kind`` ("nerf", "img", "sdf") lets it read a JAX run's checkpoint.
    Under data parallelism every rank waits at a barrier first, then reads
    the same file."""
    dev = next(next(iter(state["models"].values())).parameters()).device
    mesh.barrier()
    found = ckpt_lib.restore_latest(log_path, map_location=dev)
    if found is None:
        return 0, state
    step, saved = found
    saved = weights.restore_state(saved, kind)
    for k, m in state["models"].items():
        m.load_state_dict(saved["models"][k])
    load_adam(state["opt"], saved["opt"], state["models"])
    state["step"] = int(saved["step"])
    print(f"Reloading from {ckpt_lib.ckpt_path(log_path, step)}")
    return step, state


def step_profiler(config, log_path: str, device,
                  window=None) -> StepProfiler:
    """The ``profile_steps`` profiler of a run, on rank 0 only.  Raises when
    the caller's timed ``window`` context is also given: two profilers must
    not trace the same steps."""
    steps = int(config.get("profile_steps", 0))
    if steps > 0 and window is not None:
        raise ValueError("profile_steps and a timed window's context were "
                         "both asked for; give one")
    return StepProfiler(log_path, steps if mesh.is_main() else 0,
                        device=device)


def summary_module(name: str, module: torch.nn.Module) -> int:
    """Print the total parameter count (ref: pi_GAN/utils.py:14-20)."""
    n = sum(p.numel() for p in module.parameters())
    print(f"{name}: {n:,} total parameters.")
    return n


def clock(device: torch.device):
    """A point in time: an event recorded on the current CUDA stream, or the
    host's clock on the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


class TimedWindow:
    """The steps ``end - timed_steps + 1 .. end`` as one timed window.

    ``before_step(done)`` is called at the top of each step with the number
    of steps done so far, and opens the window, on an idle device, before
    the first of them; ``after_step(done)`` closes it right after the last
    one.  ``context``, a context manager such as a ``torch.profiler``
    profile, is entered for the same steps; leaving the ``with`` block
    closes it if a step raised.  ``ms()`` is the window's time, or None when
    it did not run (CUDA events on the card, the host clock on the CPU)."""

    def __init__(self, device: torch.device, end: int, timed_steps: int,
                 context=None):
        self.device, self.end, self.context = device, end, context
        self.start = end - timed_steps if timed_steps > 0 else None
        self._stack = contextlib.ExitStack()
        self._opened = self._closed = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def before_step(self, done: int):
        if done == self.start and self._opened is None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if self.context is not None:
                self._stack.enter_context(self.context)
            self._opened = clock(self.device)

    def after_step(self, done: int):
        if (self._opened is not None and self._closed is None
                and done == self.end):
            self._closed = clock(self.device)
            self._stack.close()

    def ms(self) -> float | None:
        if self._closed is None:
            return None
        if self.device.type == "cuda":
            self._closed.synchronize()
            return self._opened.elapsed_time(self._closed)
        return 1e3 * (self._closed - self._opened)


def launch(argv) -> tuple[list, str | None]:
    """A driver's argv -> (argv without ``--device D`` and ``--backend B``,
    D or None).  Under ``torchrun`` it joins the process group first, over
    B (``mesh.init_from_env``: NCCL with a card per rank when B is not
    given)."""
    argv = list(argv)
    opts = {}
    for flag in ("--device", "--backend"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i:i + 2]
    mesh.init_from_env(opts.get("--backend"))
    return argv, opts.get("--device")


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

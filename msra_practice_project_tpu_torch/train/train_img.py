"""SIREN image fitting: f(x, y) -> intensity on one grayscale image (port of
``msra_practice_project_tpu/train/train_img.py``, ref: siren/train_img.py).

  * The whole image as one shuffled ``[H*W, 3]`` buffer of (x, y, value) on
    the device, built by numpy exactly as the JAX package builds it; each
    step slices its batch out of it.
  * MSE and one constant-rate Adam step; PSNR from the batch loss.
  * Full-grid renders every ``i_image`` steps, the log written before each
    checkpoint, and a resume that truncates the log to the restored step.
  * ``steps_per_call`` is read but the loop runs one step per iteration:
    the JAX trainer scans that many steps per dispatch, which is the same
    math.
  * The MLP is plain PyTorch on either device (``models/siren_mlp.py``),
    in strict fp32 (``set_plain_precision``).

Not in this port yet: the step profiler, NaN debugging and data
parallelism.

Run: python -m msra_practice_project_tpu_torch.train.train_img <config.json>
"""

from __future__ import annotations

import os
import sys

import torch

from .. import resolve_device, set_plain_precision
from ..core import ckpt as ckpt_lib
from ..core import image_io
from ..core.config import SIREN_IMG_DEFAULTS, log_dir, save_config
from ..core.diagnostics import watchdog_from_config
from ..core.logging import MetricLogger, log_print
from ..data import image as image_data
from ..models.siren_mlp import img_model
from . import common

DEFAULT_IMAGE = "./data/image/cameraman.jpg"


def make_train_step(model, opt):
    """Returns step(batch [B, 3]) -> {"loss", "psnr"}, which updates the
    model in place."""
    def step(batch):
        pos, target = batch[:, :2], batch[:, 2:]
        loss = torch.mean((model(pos) - target) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        loss = loss.detach()
        return {"loss": loss, "psnr": -10.0 * torch.log10(loss)}

    return step


def render_grid(model, width: int, height: int) -> torch.Tensor:
    """Full-grid eval -> ``[H, W]`` on the model's device
    (ref: siren/utils_img.py:6-16)."""
    dev = next(model.parameters()).device
    xs, ys = torch.meshgrid(torch.linspace(-1, 1, width, device=dev),
                            torch.linspace(-1, 1, height, device=dev),
                            indexing="xy")
    pos = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1)
    with torch.no_grad():
        return model(pos).reshape(height, width)


def load_image(config):
    """The configured image, or the synthetic band-limited one when the
    file does not exist (the reference hardcodes cameraman.jpg,
    siren/train_img.py:32)."""
    data_path = config.get("data_path", DEFAULT_IMAGE)
    if os.path.exists(data_path):
        return image_data.load_image_grayscale(data_path)
    log_print(f"[data] {data_path} not found - using synthetic image")
    return image_data.make_synthetic_image(config.get("data_size", 256))


def train(config, device=None, timed_steps=0, window=None) -> dict:
    """Train from a resolved config; runs on CUDA unless ``device='cpu'``.

    With ``timed_steps`` > 0 the last that many steps are one timed window
    (``common.TimedWindow``), with ``window`` entered for them.  Returns the
    state, the metric log, the model, the image, its geometry and
    ``window_ms`` (None when the window did not run)."""
    device = resolve_device(device)
    set_plain_precision()
    log_path = log_dir(config)
    os.makedirs(log_path, exist_ok=True)
    save_config(config, log_path)
    watchdog = watchdog_from_config(config, log_path)

    img = load_image(config)
    height, width = img.shape[:2]
    buffer = torch.from_numpy(
        image_data.image_to_coords(img, shuffle=True)).to(device)
    n = buffer.shape[0]
    batch_size = min(config["batch_size"], n)

    gen = torch.Generator().manual_seed(config.get("seed", 0))
    model = img_model(config["model_type"], generator=gen).to(device)
    opt = common.adam(list(model.parameters()), config["learning_rate"])
    state = common.init_state({"model": model}, opt)
    global_step, state = common.resume(log_path, state)
    step_fn = make_train_step(model, opt)

    logger = MetricLogger(["loss", "psnr"])
    log_file = os.path.join(log_path, "log.npy")
    if global_step and os.path.exists(log_file):
        # the merged log spans the whole run across restarts
        logger.preload(MetricLogger.load(log_file), global_step)

    batch_idx, epoch_idx = 0, 0
    batch_num = max(n // batch_size, 1)
    iterations = config["iterations"]
    with common.TimedWindow(device, iterations, timed_steps,
                            window) as timer:
        while global_step < iterations:
            timer.before_step(global_step)
            watchdog.beat(f"step {global_step}")
            lo = batch_idx * batch_size
            m = step_fn(buffer[lo:lo + batch_size])
            logger.append(loss=m["loss"], psnr=m["psnr"])
            batch_idx += 1
            epoch_idx += batch_idx // batch_num
            batch_idx %= batch_num
            global_step += 1
            state["step"] = global_step
            timer.after_step(global_step)

            if global_step % config["i_print"] == 0:
                log_print(f"[Train] Iter: {global_step}({epoch_idx}-"
                          f"{batch_idx}) Loss: {float(m['loss'])} "
                          f"PSNR: {float(m['psnr'])}")
            if global_step % config["i_image"] == 0:
                image_io.imwrite(
                    os.path.join(log_path, f"{global_step:06d}.png"),
                    render_grid(model, width, height))
            if global_step % config["i_save"] == 0:
                # log before ckpt: resume truncates a log that ran ahead
                logger.save(log_path)
                p = ckpt_lib.save(log_path, global_step,
                                  common.state_dict(state))
                log_print(f"Saved checkpoints at {p}")

    # the final flush waits for the device: the watchdog stays armed
    logger.save(log_path)
    watchdog.stop()
    return {"state": state, "log": logger.data, "model": model,
            "image": img, "width": width, "height": height,
            "window_ms": timer.ms()}


def main(argv=None):
    config = common.parse_cli(argv if argv is not None else sys.argv[1:],
                              SIREN_IMG_DEFAULTS)
    train(config)


if __name__ == "__main__":
    main()

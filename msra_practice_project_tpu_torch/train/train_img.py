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

  * Data parallelism under ``torchrun`` (``parallel/mesh.py``): the model
    and Adam replicate, every rank keeps the whole buffer (the JAX package
    row-shards it over its chips to save HBM) and the same stream, and
    takes its block of each global batch; gradients and the loss are
    averaged in one all-reduce per step.  The batch must divide over the
    ranks.  Rank 0 writes the logs, images and checkpoints.
  * Resumes from the port's checkpoints or a JAX run's (``core/ckpt``,
    ``weights.train_state_from_jax``).
  * ``profile_steps``, ``debug_nans`` and ``watchdog_timeout``
    (``core/diagnostics.py``).

Run: python -m msra_practice_project_tpu_torch.train.train_img <config.json>
     torchrun --nproc_per_node=N -m msra_practice_project_tpu_torch.train.\
train_img <config.json> [--device cpu --backend gloo]
"""

from __future__ import annotations

import os
import sys

import torch

from .. import resolve_device, set_plain_precision
from ..core import ckpt as ckpt_lib
from ..core import image_io
from ..core.config import SIREN_IMG_DEFAULTS, log_dir, save_config
from ..core import diagnostics
from ..core.logging import MetricLogger, log_print
from ..data import image as image_data
from ..models.siren_mlp import img_model
from ..parallel import mesh
from . import common

DEFAULT_IMAGE = "./data/image/cameraman.jpg"


def make_train_step(model, opt):
    """Returns step(batch [B, 3]) -> {"loss", "psnr"}, which updates the
    model in place.  Under data parallelism ``batch`` is the global batch:
    each rank takes its block, and the gradients and the loss are averaged
    over the ranks before Adam."""
    params = list(model.parameters())

    def step(batch):
        batch = mesh.local_slice(batch)
        pos, target = batch[:, :2], batch[:, 2:]
        loss = torch.mean((model(pos) - target) ** 2)
        opt.zero_grad()
        loss.backward()
        (loss,) = mesh.all_reduce_grads(params, loss.detach())
        opt.step()
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
    main = mesh.is_main()
    if main:
        save_config(config, log_path)
    profiler = common.step_profiler(config, log_path, device, window)

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
    global_step, state = common.resume(log_path, state, "img")
    mesh.broadcast_state(model)
    if mesh.world() > 1:
        mesh.check_divides("batch_size", batch_size)
        if main:
            log_print(f"[parallel] data-parallel over {mesh.world()} ranks")
    step_fn = make_train_step(model, opt)

    logger = MetricLogger(["loss", "psnr"])
    log_file = os.path.join(log_path, "log.npy")
    if global_step and os.path.exists(log_file):
        # the merged log spans the whole run across restarts
        logger.preload(MetricLogger.load(log_file), global_step)

    batch_idx, epoch_idx = 0, 0
    batch_num = max(n // batch_size, 1)
    iterations = config["iterations"]
    with diagnostics.enable_from_config(config) as nans, \
            diagnostics.watchdog_from_config(config, log_path) as watchdog, \
            common.TimedWindow(device, iterations, timed_steps,
                               window) as timer:
        while global_step < iterations:
            timer.before_step(global_step)
            profiler.tick(global_step + 1)
            watchdog.beat(f"step {global_step}")
            lo = batch_idx * batch_size
            m = step_fn(buffer[lo:lo + batch_size])
            nans.check(global_step + 1, loss=m["loss"])
            logger.append(loss=m["loss"], psnr=m["psnr"])
            batch_idx += 1
            epoch_idx += batch_idx // batch_num
            batch_idx %= batch_num
            global_step += 1
            state["step"] = global_step
            timer.after_step(global_step)

            if global_step % config["i_print"] == 0 and main:
                log_print(f"[Train] Iter: {global_step}({epoch_idx}-"
                          f"{batch_idx}) Loss: {float(m['loss'])} "
                          f"PSNR: {float(m['psnr'])}")
            if global_step % config["i_image"] == 0 and main:
                image_io.imwrite(
                    os.path.join(log_path, f"{global_step:06d}.png"),
                    render_grid(model, width, height))
            if global_step % config["i_save"] == 0 and main:
                # log before ckpt: resume truncates a log that ran ahead
                logger.save(log_path)
                p = ckpt_lib.save(log_path, global_step,
                                  common.state_dict(state))
                log_print(f"Saved checkpoints at {p}")

        profiler.stop()
        # the final flush waits for the device: the watchdog stays armed
        if main:
            logger.save(log_path)
        log = logger.data
    return {"state": state, "log": log, "model": model,
            "image": img, "width": width, "height": height,
            "window_ms": timer.ms()}


def main(argv=None):
    argv, device = common.launch(argv if argv is not None else sys.argv[1:])
    config = common.parse_cli(argv, SIREN_IMG_DEFAULTS)
    train(config, device)


if __name__ == "__main__":
    main()

"""NeRF training on Blender-synthetic scenes (port of
``msra_practice_project_tpu/train/train_nerf.py``).

  * All train rays + rgba as one shuffled ``[N*H*W, 10]`` buffer on the
    device; the start-up phase (the first ``start_up_itrs`` iterations) draws
    from the centre crop of one random train image.
  * Coarse+fine MSE (+0.1 * alpha loss with ``use_alpha``), one Adam over
    both models with lr * 0.1^(step / (decay * 1000)).
  * Epoch reshuffle really reshuffles (the reference's is a no-op bug).
  * On CUDA both MLP calls of the PE NeRF's step go through the fused
    kernels (``ops/kernels/nerf_mlp.py``: K1 forward with saved activations,
    K2 backward, bf16 tensor-core matmuls), as ``use_fused_mlp`` does on the
    TPU; ``use_fused_mlp=False``, the SIREN NeRF and the CPU use the plain
    models (``uses_fused_mlp``).
  * ``steps_per_call`` is read but the loop runs one step per iteration: the
    JAX trainer scans that many steps per dispatch, which is the same math.
  * Exact resume: the batch stream is a pure function of (seed, config,
    step).  The models are drawn from a generator of their own, the first
    shuffle and each epoch's permutation from generators seeded from (seed,
    boundary step), each start-up batch and each step's stratified jitter
    from generators seeded from (seed, step), and the eval image from its
    own.  A resumed run replays the elapsed permutations and restores the
    batch cursor, so it continues the uninterrupted run's stream.
  * Data parallelism under ``torchrun`` (``parallel/mesh.py``): the models
    and Adam replicate; every rank keeps the whole ray buffer (640 MB for
    lego at 400x400; the JAX package row-shards it over its chips to save
    HBM) and the same stream, and takes its block of each global batch and
    of that batch's jitter, drawn whole on every rank, so the run computes
    what one process computes.  Gradients and losses are averaged in one
    all-reduce per step.  Rank 0 writes the logs, images and checkpoints.
  * ``profile_steps``, ``debug_nans`` and ``watchdog_timeout``
    (``core/diagnostics.py``).

Run: python -m msra_practice_project_tpu_torch.train.train_nerf <config.json>
     torchrun --nproc_per_node=N -m msra_practice_project_tpu_torch.train.\
train_nerf <config.json> [--device cpu --backend gloo]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import resolve_device, set_plain_precision
from ..core import ckpt as ckpt_lib
from ..core import diagnostics, image_io
from ..core.config import NERF_TRAIN_DEFAULTS, log_dir, save_config
from ..core.logging import MetricLogger, log_print
from ..data import blender
from ..models.nerf import nerf_model
from ..ops import rays as ray_ops
from ..ops.kernels.nerf_mlp import fused_nerf_apply
from ..ops.render import render_image, render_rays
from ..parallel import mesh
from . import common


# ---------------------------------------------------------------------------
# Ray pre-batching
# ---------------------------------------------------------------------------


def _ray_rows(img, pose, width, height, focal, device):
    ro, rd = ray_ops.get_rays(width, height, focal,
                              torch.as_tensor(pose[:3, :4], device=device))
    rgba = torch.as_tensor(np.ascontiguousarray(img), device=device)
    return torch.cat([ro.reshape(-1, 3), rd.reshape(-1, 3),
                      rgba.reshape(-1, 4)], dim=1)


def build_ray_buffer(images, poses, width, height, focal,
                     generator: torch.Generator, device=None):
    """All train rays+rgba as one shuffled buffer ``[N*H*W, 10]``
    (ref: nerf/train_nerf.py:78-86)."""
    buf = torch.cat([_ray_rows(img, pose, width, height, focal, device)
                     for img, pose in zip(images, poses)], dim=0)
    perm = torch.randperm(buf.shape[0], generator=generator)
    return buf[perm.to(buf.device)]


def build_startup_buffer(images, poses, width, height, focal, device=None):
    """Centre-crop ray buffer per train image ``[N, s_h*s_w, 10]``: rays of
    a half-size image with the same focal, i.e. the centre crop of the full
    image's ray grid (ref: nerf/train_nerf.py:125-137)."""
    s_w, s_h = int(width / 2), int(height / 2)
    s_left, s_top = int(width / 4), int(height / 4)
    return torch.stack([
        _ray_rows(img[s_top:s_top + s_h, s_left:s_left + s_w], pose, s_w,
                  s_h, focal, device)
        for img, pose in zip(images, poses)])


def sample_startup_batch(startup_buf, generator: torch.Generator,
                         batch_size: int):
    """One random image, ``batch_size`` crop rays without replacement
    (with replacement only when the crop has fewer pixels than the batch)
    (ref: nerf/train_nerf.py:128-137)."""
    n_img, n_px = startup_buf.shape[:2]
    img_idx = int(torch.randint(0, n_img, (1,), generator=generator))
    if batch_size > n_px:
        rows = torch.randint(0, n_px, (batch_size,), generator=generator)
    else:
        rows = torch.randperm(n_px, generator=generator)[:batch_size]
    return startup_buf[img_idx][rows.to(startup_buf.device)]


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def uses_fused_mlp(cfg, device) -> bool:
    """Whether the step's MLP calls go through the fused kernels: the PE
    NeRF on CUDA unless ``use_fused_mlp`` is false, as the JAX trainer
    sends it to its Pallas kernel on the TPU (JAX
    ``train/train_nerf.py:97-99``).  The SIREN NeRF (no kernel in either
    package), ``use_fused_mlp=False`` and the CPU run the plain models."""
    return (torch.device(device).type == "cuda"
            and bool(cfg.get("use_fused_mlp", True))
            and not cfg.get("use_siren", False))


def make_train_step(coarse_model, fine_model, opt, cfg, device):
    """Returns step(batch [B,10], *, generator=None, jitter=None) -> metrics,
    which updates the models in place.  ``jitter`` ([B, n_coarse]) replaces
    the stratified draws from ``generator``.  The MLP runs through the fused
    kernels where ``uses_fused_mlp`` says so, else through the plain
    models.

    Under data parallelism ``batch`` is the global batch: each rank draws
    the whole batch's jitter, keeps its block of both, and the gradients
    and metrics are averaged over the ranks before Adam."""
    use_fine = cfg["use_fine_model"]
    use_alpha = cfg["use_alpha"]
    near, far = cfg["render_near"], cfg["render_far"]
    nc, nf = cfg["render_coarse_sample_num"], cfg["render_fine_sample_num"]
    if uses_fused_mlp(cfg, device):
        # need_dx=False: the points come from ray data and detached depths;
        # save_acts=True: K1 spills the activations so K2 skips the
        # recompute, as the JAX trainer passes them.
        apply_c = lambda x: fused_nerf_apply(  # noqa: E731
            coarse_model, x, True, need_dx=False, save_acts=True)
        apply_f = lambda x: fused_nerf_apply(  # noqa: E731
            fine_model, x, True, need_dx=False, save_acts=True)
    else:
        apply_c, apply_f = coarse_model, fine_model
    if not use_fine:
        apply_f = apply_c
    params = [p for g in opt.opt.param_groups for p in g["params"]]
    dp = mesh.world() > 1

    def step(batch, *, generator=None, jitter=None):
        with diagnostics.span("nerf.step"):
            return _step(batch, generator, jitter)

    def _step(batch, generator, jitter):
        with diagnostics.span("nerf.render"):
            if dp:
                if jitter is None:
                    jitter = torch.rand((batch.shape[0], nc),
                                        generator=generator,
                                        device=batch.device)
                batch = mesh.local_slice(batch)
                jitter = mesh.local_slice(jitter)
            rays_o, rays_d = batch[:, 0:3], batch[:, 3:6]
            out = render_rays(rays_o, rays_d, near, far, apply_c, apply_f,
                              nc, nf, generator=generator, jitter=jitter)
        with diagnostics.span("nerf.loss"):
            target_rgb, target_alpha = batch[:, 6:9], batch[:, 9]
            loss_coarse = torch.mean((out["rgb_coarse"] - target_rgb) ** 2)
            loss_fine = torch.mean((out["rgb_fine"] - target_rgb) ** 2)
            mse_fine = loss_fine.detach()
            if use_alpha:
                loss_coarse = loss_coarse + 0.1 * torch.mean(
                    (out["acc_coarse"] - target_alpha) ** 2)
                loss_fine = loss_fine + 0.1 * torch.mean(
                    (out["acc_fine"] - target_alpha) ** 2)
            loss = loss_fine + loss_coarse if use_fine else loss_fine
        with diagnostics.span("nerf.backward"):
            opt.zero_grad()
            loss.backward()
            loss, loss_coarse, loss_fine = (
                loss.detach(), loss_coarse.detach(), loss_fine.detach())
            if dp:
                loss, loss_coarse, loss_fine, mse_fine = \
                    mesh.all_reduce_grads(params, loss, loss_coarse,
                                          loss_fine, mse_fine)
        opt.step()
        return {"loss": loss, "loss_coarse": loss_coarse,
                "loss_fine": loss_fine, "psnr": -10.0 * torch.log10(mse_fine)}

    return step


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def load_dataset(config):
    data_path = config["data_path"]
    if os.path.isdir(data_path):
        images, poses, width, height, focal, train_idx = \
            blender.load_blender_data(
                data_path, config["data_resize"], config["data_skip"],
                config["data_view_dir_range"], config["data_target_num"],
                config["data_train_idx"],
                rng=np.random.default_rng(config.get("seed", 0)))
    else:
        tmp = os.path.join(log_dir(config), "_synthetic_data")
        if mesh.is_main():
            log_print(f"[data] {data_path!r} not found - generating "
                      "synthetic blender scene")
            blender.make_synthetic_blender(tmp,
                                           size=config.get("data_size", 32))
        mesh.barrier()
        images, poses, width, height, focal, train_idx = \
            blender.load_blender_data(tmp, 1.0, 1)
    blender.premultiply_white(images)
    if config["data_view_dir_noise"] is not None:
        poses["train"] = poses["train"] + (
            np.random.default_rng(0).normal(size=poses["train"].shape)
            * np.sqrt(config["data_view_dir_noise"])).astype(np.float32)
    return images, poses, width, height, focal, train_idx


def _epoch_perm(n_rays: int, seed: int, boundary: int) -> torch.Tensor:
    """The permutation of the epoch that starts at ``boundary`` (the global
    step after which it is drawn; 0 is the first shuffle)."""
    gen = torch.Generator().manual_seed(common.fold_seed(seed + 1,
                                                         boundary + 1))
    return torch.randperm(n_rays, generator=gen)


def train(config, device=None, timed_steps=0, window=None) -> dict:
    """Train from a resolved config; runs on CUDA unless ``device='cpu'``.

    With ``timed_steps`` > 0 the last that many steps are one timed window
    (``common.TimedWindow``): it opens at the top of the first of them, on
    an idle device, and closes right after the last one (before that
    iteration's print, checkpoint and image), and everything in between
    counts.  ``window``, a context manager such as a
    ``torch.profiler.profile``, is entered for the same steps (not with
    ``profile_steps``: one profiler at a time).

    Returns the state, the metric log, the models, the image geometry and
    ``window_ms``, the window's time (None when it did not run)."""
    device = resolve_device(device)
    set_plain_precision()
    log_path = log_dir(config)
    os.makedirs(log_path, exist_ok=True)
    main = mesh.is_main()
    profiler = common.step_profiler(config, log_path, device, window)

    images, poses, width, height, focal, train_idx = load_dataset(config)
    if config.get("data_show_distribution", False) and main:
        blender.show_data_distribution(
            poses, save_path=os.path.join(log_path, "distribution.png"))
    config["data_train_idx"] = train_idx
    if main:
        path = save_config(config, log_path)
        log_print(f"Config file write to: {path}")

    seed = config.get("seed", 0)
    startup = config["start_up_itrs"]
    buf = build_ray_buffer(
        images["train"], poses["train"], width, height, focal,
        torch.Generator().manual_seed(common.fold_seed(seed + 1, 0)), device)
    startup_buf = (build_startup_buffer(images["train"], poses["train"],
                                        width, height, focal, device)
                   if startup > 0 else None)
    batch_size = config["batch_size"]
    n_rays = buf.shape[0]
    batch_num = int(np.ceil(n_rays / batch_size))
    if main:
        log_print(f"Batching Finished: size={tuple(buf.shape)}, "
                  f"batch_size={batch_size}, batch_num={batch_num}")
    if mesh.world() > 1:
        mesh.check_divides("batch_size", batch_size)
        if main:
            log_print(f"[parallel] data-parallel over {mesh.world()} ranks "
                      f"(batch {batch_size // mesh.world()} rays a rank)")

    # One Adam over both models, as the reference concatenates the
    # parameter lists (nerf/train_nerf.py:95-98).
    init_gen = torch.Generator().manual_seed(seed)
    models = {"coarse": nerf_model(config["use_siren"], generator=init_gen)}
    if config["use_fine_model"]:
        models["fine"] = nerf_model(config["use_siren"], generator=init_gen)
    for m in models.values():
        m.to(device)
    coarse_model = models["coarse"]
    fine_model = models.get("fine", coarse_model)
    params = [p for m in models.values() for p in m.parameters()]
    opt = common.adam(params, common.exponential_lr(
        config["learning_rate"], config["learning_rate_decay"]))
    state = common.init_state(models, opt)
    global_step, state = common.resume(log_path, state, "nerf")
    mesh.broadcast_state(*models.values())

    # Exact resume: replay the elapsed epochs' permutations and restore the
    # batch cursor (JAX train/train_nerf.py:287-311).  A buffer smaller than
    # a batch (epoch_len 0) reshuffles at every step after the start-up.
    batch_idx = 0
    epoch_len = n_rays // batch_size
    if global_step > startup:
        done = global_step - startup
        boundaries = (range(startup + epoch_len, global_step + 1, epoch_len)
                      if epoch_len else range(startup, global_step))
        if boundaries:
            idx = torch.arange(n_rays)
            for g in boundaries:
                idx = idx[_epoch_perm(n_rays, seed, g)]
            buf = buf[idx.to(buf.device)]
        batch_idx = done % epoch_len if epoch_len else 0
        if main:
            log_print(f"[resume] replayed {len(boundaries)} epoch "
                      f"permutations, batch cursor {batch_idx}/{epoch_len}")

    step_fn = make_train_step(coarse_model, fine_model, opt, config, device)
    logger = MetricLogger(["loss", "psnr"])
    if global_step > 0:
        log_file = os.path.join(log_path, "log.npy")
        if os.path.exists(log_file):
            logger.preload(MetricLogger.load(log_file), global_step)

    host_gen = torch.Generator()
    step_gen = torch.Generator(device=device)
    iterations = config["iterations"]
    # The step is host-paced: the hooks that are off cost no call per step.
    profiling = profiler.steps > 0
    with diagnostics.enable_from_config(config) as nans, \
            diagnostics.watchdog_from_config(config, log_path) as watchdog, \
            common.TimedWindow(device, iterations, timed_steps,
                               window) as timer:
        while global_step < iterations:
            timer.before_step(global_step)
            if profiling:
                profiler.tick(global_step + 1)
            if watchdog.enabled:
                watchdog.beat(f"step {global_step}")
            # Epoch boundary: a real reshuffle.
            if (global_step >= startup
                    and (batch_idx + 1) * batch_size > n_rays):
                perm = _epoch_perm(n_rays, seed, global_step)
                buf = buf[perm.to(buf.device)]
                batch_idx = 0

            global_step += 1
            if global_step <= startup:
                host_gen.manual_seed(common.fold_seed(seed + 2, global_step))
                batch = sample_startup_batch(startup_buf, host_gen,
                                             batch_size)
            else:
                lo = batch_idx * batch_size
                batch = buf[lo:lo + batch_size]
                batch_idx += 1
            state["step"] = global_step
            step_gen.manual_seed(common.fold_seed(seed + 3, global_step))
            m = step_fn(batch, generator=step_gen)
            if nans.enabled:
                nans.check(global_step, loss=m["loss"])
            logger.append(loss=m["loss"], psnr=m["psnr"])
            timer.after_step(global_step)

            if global_step % config["i_print"] == 0 and main:
                rate = config["i_print"] / max(logger.step_time(), 1e-9)
                log_print(f"[Train] Iter: {global_step} "
                          f"Loss: {float(m['loss'])} PSNR: {float(m['psnr'])} "
                          f"({rate:.1f} steps/s)")
            if global_step % config["i_save"] == 0 and main:
                # log before ckpt: resume truncates a log that ran ahead
                logger.save(log_path)
                p = ckpt_lib.save(log_path, global_step,
                                  common.state_dict(state))
                log_print(f"Saved checkpoints at {p}")
            if global_step % config["i_image"] == 0:
                # every rank renders its block of the view's tiles
                eval_gen = torch.Generator(device=device).manual_seed(
                    common.fold_seed(seed + 4, global_step))
                frame = render_eval_image(config, coarse_model, fine_model,
                                          width, height, focal, eval_gen,
                                          device=device)
                if main:
                    image_io.imwrite(
                        os.path.join(log_path, f"{global_step:06d}.png"),
                        frame)
        profiler.stop()
        # the final flush waits for the device: the watchdog stays armed
        if main:
            logger.save(log_path)
        log = logger.data
    return {"state": state, "log": log,
            "models": (coarse_model, fine_model),
            "geometry": (width, height, focal), "window_ms": timer.ms()}


def render_eval_image(config, coarse_model, fine_model, width, height, focal,
                      generator=None, pose=None, device=None):
    """Eval render from the fixed pose (4, 0, 0) with the plain models
    (ref: nerf/train_nerf.py:191-201); under a process group every rank
    calls it and renders its block of the tiles (``render_image``)."""
    if pose is None:
        pose = ray_ops.camera_pose_deg(4.0, 0.0, 0.0)
    fine = fine_model if config["use_fine_model"] else coarse_model
    rgb, _, _ = render_image(
        width, height, focal, pose, config["render_near"],
        config["render_far"], coarse_model, fine,
        config["render_coarse_sample_num"], config["render_fine_sample_num"],
        generator=generator, device=device)
    return rgb.cpu().numpy()


def main(argv=None):
    argv, device = common.launch(argv if argv is not None else sys.argv[1:])
    config = common.parse_cli(argv, NERF_TRAIN_DEFAULTS)
    train(config, device)


if __name__ == "__main__":
    main()

"""pi-GAN training: progressive-resolution adversarial training (port of
``msra_practice_project_tpu/train/train_pigan.py``).

  * The generator renders the whole latent batch in one computation; on CUDA
    its FiLM trunk runs through the kernels of ``ops/kernels/film_mlp.py``
    in the mode ``MSRA_TPU_FUSED_FILM`` picks (models/pigan.py: 1, the
    default, is K8 forward in fp32 with K7 in bf16 as its backward; 2 is K8
    forward and K7 backward, both in bf16).
  * Non-saturating losses with the reference's sign convention
    (pi_GAN/utils.py:28-29, train.py:117,133): loss_f(u) = -softplus(-u),
    d_loss = -E[loss_f(D(fake))] - E[loss_f(-D(real))] + lambda * R1,
    g_loss = E[loss_f(D(fake))].
  * The R1 penalty E[||grad_x D(x)||^2] on the real images, through
    ``torch.autograd.grad(create_graph=True)`` (pi_GAN/utils.py:32-37).
  * Progressive stages from the config lists (iterations, fade_in_itrs,
    batch_size, resolution; pi_GAN/train.py:30-33), the fade-in alpha ramp,
    and two Adams with betas (0, 0.9) and the interpolated exponential decay
    (pi_GAN/train.py:138-147).
  * The knobs beyond the reference driver, each off by default (its exact
    dynamics): ``r1_lambda``, ``instance_noise`` with its anneal and floor,
    ``d_skip_margin``, ``diff_augment``, ``g_nonsat``.
  * Randomness: every iteration reseeds one device generator from (seed,
    iteration), so a resumed run draws what the uninterrupted run drew.
  * Data parallelism under ``torchrun`` (``parallel/mesh.py``): G, D and
    both Adams replicate; every rank reads the whole real batch (the image
    folder's order is seeded alike on every rank) and draws the whole
    batch's z, poses, stratified jitter, instance noise and DiffAugment
    parameters from the same generator, then keeps its block of each, so
    the run computes what one process computes.  Each step averages its
    gradients and metrics in one all-reduce; D's skip decision reads the
    averaged E[D(fake)].  Every stage's batch must divide over the ranks.
    Rank 0 writes the logs, images and checkpoints.
  * Resumes from the port's checkpoints or a JAX run's (``core/ckpt``,
    ``weights.train_state_from_jax``).
  * ``profile_steps``, ``debug_nans`` and ``watchdog_timeout``
    (``core/diagnostics.py``).

Run: python -m msra_practice_project_tpu_torch.train.train_pigan <config.json>
     torchrun --nproc_per_node=N -m msra_practice_project_tpu_torch.train.\
train_pigan <config.json> [--device cpu --backend gloo]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device, set_plain_precision, weights
from ..core import ckpt as ckpt_lib
from ..core import diagnostics
from ..core.config import PIGAN_TRAIN_DEFAULTS, log_dir, save_config
from ..core.logging import flush_scalar_list, log_print
from ..data.image_folder import ImageFolder, make_synthetic_faces
from ..models import pigan
from ..parallel import mesh
from . import common


def loss_f(u):
    """-softplus(-u) == log sigmoid(u) (ref: pi_GAN/utils.py:28-29)."""
    return -F.softplus(-u)


def r1_penalty(labels, x):
    """E[||grad_x D(x)||^2] over the batch (ref: pi_GAN/utils.py:32-37) for
    labels = D(x), x a leaf that requires grad; the graph is kept so the
    penalty can be differentiated again."""
    (g,) = torch.autograd.grad(labels.sum(), x, create_graph=True)
    return g.reshape(x.shape[0], -1).pow(2).sum(dim=-1).mean()


def noise_schedule(noise0: float, anneal: int, floor: float,
                   step: int) -> float:
    """Instance-noise std at ``step``: linear anneal from noise0 to ``floor``
    over ``anneal`` iterations (floor 0 = the anneal to zero)."""
    return max(floor, noise0 * max(0.0, 1.0 - step / max(anneal, 1)))


def make_gan_steps(g_model: pigan.Generator,
                   d_model: pigan.Discriminator, g_opt, d_opt,
                   resolution: int, r1_lambda: float = 1.0,
                   instance_noise: bool = False,
                   d_skip_margin: float | None = None,
                   diff_augment_policy: str = "",
                   g_nonsat: bool = False):
    """(d_step, g_step) for a progressive stage; each updates its model in
    place and returns its metrics (device scalars).

    ``instance_noise`` adds N(0, noise_std^2) pixel noise to real and fake
    images before D; ``d_skip_margin`` drops D's update (its optimizer state
    too) when E[D(fake)] >= the margin; ``diff_augment_policy`` applies
    DiffAugment to real and fake before D; ``g_nonsat`` swaps G's saturating
    loss for E[softplus(D(fake))].  Off, each is the reference's dynamics.

    Both steps take ``generator`` (a torch.Generator on the device) for the
    poses, the stratified jitter, the noise and the augmentation draws;
    ``poses`` (theta, phi) and ``jitter`` replace the first two.

    ``real`` and ``z`` are the global batch: under data parallelism every
    draw is made for the whole batch and each rank keeps its block
    (``mesh.local_slice``), and the gradients and metrics are averaged over
    the ranks before each Adam step."""
    use_aug = bool(diff_augment_policy)
    if use_aug:
        from . import diff_augment as da
        da.parse_policy(diff_augment_policy)  # fail fast on a bad policy
    g_params = list(g_model.parameters())
    d_params = list(d_model.parameters())
    local = mesh.local_slice

    def g_inputs(z, gen, poses, jitter):
        """This rank's z, poses and jitter, the last two drawn for the
        whole batch (in the order the generator's forward draws them)."""
        n = z.shape[0]
        if poses is None:
            poses = g_model.sample_poses(n, gen, z.device)
        if jitter is None:
            jitter = torch.rand(
                (n, resolution * resolution, g_model.cfg.coarse_samples),
                generator=gen, device=z.device)
        return local(z), tuple(local(p) for p in poses), local(jitter)

    def before_d(x, noise_std, gen, n):
        # x: this rank's rows of a global batch of n images
        if use_aug:
            x = da.augment(x, diff_augment_policy, gen, n)
        if instance_noise:
            x = x + noise_std * local(torch.randn(
                (n, *x.shape[1:]), generator=gen, device=x.device))
        return x

    def reduced_grads(params, loss, *metrics):
        # a parameter the loss does not reach (the discriminator's blocks
        # above the stage's entry) gets a zero gradient, as optax gives it
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        return mesh.all_reduce_grads(params, loss.detach(), *metrics)

    def d_step(real, z, alpha, noise_std=0.0, *, generator=None, poses=None,
               jitter=None):
        with diagnostics.span("gan.d_step"):
            return _d_step(real, z, alpha, noise_std, generator, poses,
                           jitter)

    def _d_step(real, z, alpha, noise_std, generator, poses, jitter):
        n = z.shape[0]
        with diagnostics.span("gan.fakes"):
            z, poses, jitter = g_inputs(z, generator, poses, jitter)
            with torch.no_grad():
                fake = before_d(g_model(z, resolution, poses=poses,
                                        jitter=jitter),
                                noise_std, generator, n)
        with diagnostics.span("gan.d_forward"):
            real_n = before_d(local(real), noise_std, generator, n).detach()
            real_n.requires_grad_(True)
            fake_label = d_model(fake, resolution, alpha)
            real_label = d_model(real_n, resolution, alpha)
        with diagnostics.span("gan.r1"):
            r1 = r1_penalty(real_label, real_n)
        with diagnostics.span("gan.d_backward"):
            loss = (-loss_f(fake_label).mean() - loss_f(-real_label).mean()
                    + r1_lambda * r1)
            values = reduced_grads(d_params, loss, r1.detach(),
                                   real_label.detach().mean(),
                                   fake_label.detach().mean())
        metrics = dict(zip(("d_loss", "r1", "real_label", "fake_label"),
                           values))
        if d_skip_margin is None or float(metrics["fake_label"]) < \
                d_skip_margin:
            d_opt.step()
            skipped = 0.0
        else:
            skipped = 1.0
        if d_skip_margin is not None:
            metrics["d_skipped"] = skipped
        return metrics

    def g_step(z, alpha, noise_std=0.0, *, generator=None, poses=None,
               jitter=None):
        with diagnostics.span("gan.g_step"):
            return _g_step(z, alpha, noise_std, generator, poses, jitter)

    def _g_step(z, alpha, noise_std, generator, poses, jitter):
        n = z.shape[0]
        with diagnostics.span("gan.g_forward"):
            z, poses, jitter = g_inputs(z, generator, poses, jitter)
            fake = before_d(g_model(z, resolution, poses=poses,
                                    jitter=jitter), noise_std, generator, n)
        with diagnostics.span("gan.g_d_forward"):
            fake_label = d_model(fake, resolution, alpha)
            loss = (F.softplus(fake_label).mean() if g_nonsat
                    else loss_f(fake_label).mean())
        with diagnostics.span("gan.g_backward"):
            (g_loss,) = reduced_grads(g_params, loss)
        g_opt.step()
        return {"g_loss": g_loss}

    return d_step, g_step


def save_demo_grid(gen_model, path, rows=4, cols=4, resolution=None,
                   generator=None):
    """rows x cols random-sample grid (ref: pi_GAN/utils.py:185-204), through
    the demo's chunked render."""
    from ..eval.pigan_demo import save_demo

    save_demo(gen_model, path, rows=rows, columns=cols,
              resolution=resolution or gen_model.cfg.resolution,
              coarse=gen_model.cfg.coarse_samples,
              fine=gen_model.cfg.fine_samples, generator=generator)


def stage_of(global_step: int, iterations: list[int]) -> int:
    """iterations already [0]-prefixed (ref: pi_GAN/train.py:44,79-84)."""
    stage = 0
    for i in range(len(iterations)):
        if global_step > iterations[i]:
            stage = i
        else:
            break
    return stage


def _flush(loss_log: dict) -> None:
    for k, vs in loss_log.items():
        loss_log[k] = flush_scalar_list(vs)


def train(config, device=None, timed_steps=0, window=None,
          window_end=None) -> dict:
    """Train from a resolved config; runs on CUDA unless ``device='cpu'``.

    With ``timed_steps`` > 0, iterations ``window_end - timed_steps + 1``
    .. ``window_end`` (``window_end`` defaults to the last iteration) are one
    timed window: it opens at the top of the first of them, on an idle
    device, and closes right after the last one's steps (before its print,
    checkpoint and image).  ``window``, a context manager such as a
    ``torch.profiler.profile``, is entered for the same iterations (not
    with ``profile_steps``: one profiler at a time).

    Returns the models, the optimizers, the loss log and ``window_ms``, the
    window's time (None when it did not run)."""
    device = resolve_device(device)
    set_plain_precision()
    log_path = log_dir(config)
    os.makedirs(log_path, exist_ok=True)
    main = mesh.is_main()
    if main:
        save_config(config, log_path)
    profiler = common.step_profiler(config, log_path, device, window)

    iterations = [0] + list(config.iterations)
    fade_in_itrs = list(config.fade_in_itrs)
    batch_sizes = list(config.batch_size)
    resolutions = list(config.resolution)
    gen_cfg = pigan.GeneratorConfig(
        z_dim=config.z_dim, resolution=resolutions[0],
        near=config.render_near, far=config.render_far, fov=12.0,
        coarse_samples=config.render_coarse_sample_num,
        fine_samples=config.render_fine_sample_num,
        horizontal_std=0.45, vertical_std=0.15, use_dir=config.use_dir)

    seed = config.get("seed", 0)
    host_gen = torch.Generator().manual_seed(seed)
    generator = pigan.Generator(gen_cfg, generator=host_gen).to(device)
    discriminator = pigan.Discriminator(generator=host_gen).to(device)
    g_opt = common.adam(generator.parameters(), common.interp_lr(
        config.generator_lr, config.generator_lr_end, config.lr_decay),
        betas=(0.0, 0.9))
    d_opt = common.adam(discriminator.parameters(), common.interp_lr(
        config.discriminator_lr, config.discriminator_lr_end,
        config.lr_decay), betas=(0.0, 0.9))
    if main:
        common.summary_module("generator", generator)
        common.summary_module("discriminator", discriminator)
    if mesh.world() > 1:
        mesh.check_divides("batch_size", *batch_sizes)
        if main:
            log_print(f"[parallel] data-parallel over {mesh.world()} ranks")

    loss_log = {"g_loss": [], "d_loss": []}
    mesh.barrier()
    found = ckpt_lib.restore_latest(log_path, map_location=device)
    if found is not None:
        global_step, saved = found
        saved = weights.restore_state(saved, "pigan")
        generator.load_state_dict(saved["g"])
        discriminator.load_state_dict(saved["d"])
        common.load_adam(g_opt, saved["g_opt"], {"g": generator})
        common.load_adam(d_opt, saved["d_opt"], {"d": discriminator})
        # the loss history rides a sidecar .npy; keep global_step entries
        log_file = os.path.join(log_path, "loss_log.npy")
        if os.path.isfile(log_file):
            prev = np.load(log_file, allow_pickle=True).item()
            loss_log = {k: [float(v) for v in prev.get(k, [])][:global_step]
                        for k in loss_log}
        if main:
            log_print(f"Resumed at step {global_step} "
                      f"({len(loss_log['g_loss'])} logged losses)")
    else:
        global_step = 0
    mesh.broadcast_state(generator, discriminator)

    data_path = config["data_path"]
    if not os.path.isdir(data_path):
        data_path = os.path.join(log_path, "_synthetic_faces")
        if main:
            log_print(f"[data] {config['data_path']!r} not found - "
                      "generating synthetic face blobs")
            if not os.path.isdir(data_path):
                make_synthetic_faces(
                    data_path, n=config.get("data_n", 256),
                    variant=config.get("data_variant", "shaded"))
        mesh.barrier()

    r1_lambda = float(config.get("r1_lambda", 1.0))
    noise0 = float(config.get("instance_noise", 0.0))
    noise_anneal = int(config.get("instance_noise_anneal", 10000))
    noise_floor = float(config.get("instance_noise_floor", 0.0))
    d_skip_margin = config.get("d_skip_margin", None)
    d_skip_margin = None if d_skip_margin is None else float(d_skip_margin)
    aug_policy = str(config.get("diff_augment", "") or "")
    g_nonsat = bool(config.get("g_nonsat", False))
    if main and (noise0 > 0.0 or noise_floor > 0.0
                 or d_skip_margin is not None or aug_policy or g_nonsat):
        log_print(f"[train] instance noise {noise0} annealed over "
                  f"{noise_anneal} iters to floor {noise_floor}; "
                  f"r1_lambda {r1_lambda}; d_skip_margin {d_skip_margin}; "
                  f"diff_augment '{aug_policy}'; g_nonsat {g_nonsat}")

    def stage_setup(stage):
        dataset = ImageFolder(data_path, batch_sizes[stage],
                              resize=resolutions[stage] / 64.0,
                              device=device)
        steps = make_gan_steps(
            generator, discriminator, g_opt, d_opt, resolutions[stage],
            r1_lambda=r1_lambda,
            instance_noise=(noise0 > 0.0 or noise_floor > 0.0),
            d_skip_margin=d_skip_margin, diff_augment_policy=aug_policy,
            g_nonsat=g_nonsat)
        return dataset, steps

    stage = stage_of(global_step, iterations)
    dataset, (d_step, g_step) = stage_setup(stage)
    if main:
        log_print(f"Starting at stage {stage}, batch_size:"
                  f"{batch_sizes[stage]}, resolution:{resolutions[stage]}")

    step_gen = torch.Generator(device=device)
    last = iterations[-1]
    window_end = last if window_end is None else window_end
    m_d = {}
    with diagnostics.enable_from_config(config) as nans, \
            diagnostics.watchdog_from_config(config, log_path) as watchdog, \
            common.TimedWindow(device, window_end, timed_steps,
                               window) as timer:
        for global_step in range(global_step + 1, last + 1):
            timer.before_step(global_step - 1)
            profiler.tick(global_step)
            watchdog.beat(f"step {global_step}")
            epoch_idx, batch_idx, real = dataset.get()
            real = real.permute(0, 3, 1, 2).contiguous()   # NHWC -> NCHW

            # fade-in alpha ramp (ref: pi_GAN/train.py:96-98)
            fade_alpha = -1.0
            if (fade_in_itrs[stage] > 0 and global_step
                    < iterations[stage] + fade_in_itrs[stage]):
                fade_alpha = ((global_step - iterations[stage])
                              / fade_in_itrs[stage])

            step_gen.manual_seed(seed * 1_000_003 + global_step)
            noise_std = noise_schedule(noise0, noise_anneal, noise_floor,
                                       global_step)
            z = torch.randn(batch_sizes[stage], config.z_dim,
                            generator=step_gen, device=device)
            m_d = d_step(real, z, fade_alpha, noise_std, generator=step_gen)
            z = torch.randn(batch_sizes[stage], config.z_dim,
                            generator=step_gen, device=device)
            m_g = g_step(z, fade_alpha, noise_std, generator=step_gen)
            nans.check(global_step, d_loss=m_d["d_loss"],
                       g_loss=m_g["g_loss"])
            loss_log["d_loss"].append(m_d["d_loss"])
            loss_log["g_loss"].append(m_g["g_loss"])
            timer.after_step(global_step)

            # stage switch (ref: pi_GAN/train.py:149-156)
            if (stage + 1 < len(iterations)
                    and global_step == iterations[stage + 1]):
                stage += 1
                if stage < len(resolutions):
                    dataset.close()
                    dataset, (d_step, g_step) = stage_setup(stage)
                    if main:
                        log_print(f"[Train] Entering stage {stage}, "
                                  f"batch_size:{batch_sizes[stage]}, "
                                  f"resolution:{resolutions[stage]}")

            if global_step % config.i_print == 0 and main:
                _flush(loss_log)
                log_print(
                    f"[Train] Iter: {global_step}({epoch_idx}-{batch_idx}) "
                    f"d_loss: {loss_log['d_loss'][-1]} g_loss: "
                    f"{loss_log['g_loss'][-1]} fake_label: "
                    f"{float(m_d['fake_label']):.3f}"
                    + (f" d_skipped: {m_d['d_skipped']:.0f}"
                       if "d_skipped" in m_d else ""))
            if global_step % config.i_save == 0 and main:
                # the sidecar before the checkpoint: resume truncates a log
                # that ran ahead, but could not fill one left behind
                _flush(loss_log)
                np.save(os.path.join(log_path, "loss_log.npy"), loss_log)
                p = ckpt_lib.save(log_path, global_step, {
                    "g": generator.state_dict(),
                    "d": discriminator.state_dict(),
                    "g_opt": g_opt.state_dict(), "d_opt": d_opt.state_dict(),
                    "step": global_step})
                log_print(f"Saved checkpoints at {p}")
            if global_step % config.i_image == 0 and main:
                # after the last stage switch, render at the last resolution
                res_now = resolutions[min(stage, len(resolutions) - 1)]
                step_gen.manual_seed(seed * 1_000_003 + global_step + 99)
                save_demo_grid(generator,
                               os.path.join(log_path, f"{global_step:06d}.png"),
                               resolution=res_now, generator=step_gen)
        profiler.stop()
        dataset.close()
        _flush(loss_log)
    if main:
        np.save(os.path.join(log_path, "loss_log.npy"), loss_log)
    return {"generator": generator, "discriminator": discriminator,
            "g_opt": g_opt, "d_opt": d_opt, "loss_log": loss_log,
            "window_ms": timer.ms()}


def main(argv=None):
    argv, device = common.launch(argv if argv is not None else sys.argv[1:])
    config = common.parse_cli(argv, PIGAN_TRAIN_DEFAULTS)
    train(config, device)


if __name__ == "__main__":
    main()

"""GAN inversion ("synthesis"): optimise a film code to reconstruct a target
image with a frozen pi-GAN generator and discriminator (port of
``msra_practice_project_tpu/train/synthesis.py``).

The optimisation variable is one ``[9, 512]`` film code (not z); loss =
1e2 * MSE(render(film, pose 0), target) + softplus(D(render(film, random
prior pose))) (the reference's ``-mean(loss_f(-gen_label))``,
pi_GAN/synthesis.py:103).  G's and D's parameters are frozen, so the only
gradient is the film's: on CUDA, K7's ``dfilm`` (in mode 1, the default,
each render's forward is K8 in fp32 and the fine pass's backward K7 in
bf16).

The reference's sample-count block (pi_GAN/synthesis.py:33-34) assigns
``render_coarse_sample_num`` twice and leaves the fine count from config;
this implements the intent: coarse 8, fine 16.  One step per loop: the JAX
package scans ``steps_per_call`` steps per dispatch, the same math.
Every step reseeds one generator from (seed, step), so a resumed run draws
what the uninterrupted run drew.

Run: python -m msra_practice_project_tpu_torch.train.synthesis <config.json>
         [target.png] [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import ckpt as ckpt_lib
from ..core import diagnostics, image_io
from ..core.config import PIGAN_TRAIN_DEFAULTS, log_dir
from ..core.logging import flush_scalar_list
from ..eval.nerf_common import split_device_flag
from ..eval.pigan_demo import demo_multiview, demo_video, load_generator
from . import common

RESOLUTION = 64
COARSE, FINE = 8, 16
FINAL_RES, FINAL_COARSE, FINAL_FINE = 128, 32, 64  # ref: synthesis.py:131
ITERATIONS = 5000
I_PRINT, I_SAVE, I_IMAGE = 10, 1000, 100
TARGET_SEED = 123


class FilmCode(nn.Module):
    """The optimisation variable: one ``[n_film, 2h]`` film code."""

    def __init__(self, film: torch.Tensor):
        super().__init__()
        self.film = nn.Parameter(film.detach().clone())


def syn_loss(gen_model, disc, film, target, *, generator=None, draws=None):
    """(loss, {"rec", "g"}) for film ``[9, 512]`` and target ``[H, W, 3]``.
    ``draws`` = (reconstruction jitter, (theta, phi), realism jitter)
    replaces the draws from ``generator``, made in that order."""
    dev = film.device
    film_b = film[None]
    zero = torch.zeros(1, device=dev)
    jit_rec, pose, jit_real = draws if draws is not None else (None,) * 3
    # reconstruction at the canonical pose (theta = phi = 0)
    rec = gen_model.render_film(film_b, zero, zero, RESOLUTION, COARSE, FINE,
                                generator=generator, jitter=jit_rec)[0]
    rec_loss = ((rec - target) ** 2).mean()
    # realism at a random prior pose
    theta, phi = (pose if pose is not None
                  else gen_model.sample_poses(1, generator, dev))
    img = gen_model.render_film(film_b, theta, phi, RESOLUTION, COARSE, FINE,
                                generator=generator, jitter=jit_real)
    label = disc(img.permute(0, 3, 1, 2), RESOLUTION, -1.0)
    g_loss = F.softplus(label).mean()
    return 1e2 * rec_loss + g_loss, {"rec": rec_loss.detach(),
                                     "g": g_loss.detach()}


def make_syn_step(gen_model, disc, target, code: FilmCode, opt):
    """``step(generator=..., draws=...)``: one Adam update of ``code``'s
    film; returns the metrics as device scalars."""

    def step(*, generator=None, draws=None):
        loss, aux = syn_loss(gen_model, disc, code.film, target,
                             generator=generator, draws=draws)
        (code.film.grad,) = torch.autograd.grad(loss, [code.film])
        opt.step()
        return {"loss": loss.detach(), **aux}

    return step


def synthesize(config, target_path: str | None = None, device=None) -> dict:
    """Invert ``target_path`` (or, without one, a generated sample) with the
    experiment's G and D; writes ``<log_dir>_syn``.  Runs on CUDA unless
    ``device='cpu'``.  Returns the film, the loss log, the target and the
    output directory."""
    gen_model, disc, _ = load_generator(config, device)
    dev = next(gen_model.parameters()).device

    if target_path and os.path.exists(target_path):
        target = image_io.imread(target_path, resize=(RESOLUTION, RESOLUTION))
        target = torch.from_numpy(target[..., :3]).to(dev)
    else:
        # self-inversion of a generated sample (a sanity target)
        g = torch.Generator(device=dev).manual_seed(TARGET_SEED)
        zero = torch.zeros(1, device=dev)
        with torch.no_grad():
            film_t = gen_model.get_mapping(torch.randn(
                1, gen_model.cfg.z_dim, generator=g, device=dev))
            target = gen_model.render_film(film_t, zero, zero, RESOLUTION,
                                           COARSE, FINE, generator=g)[0]
        print("[data] no target image given - inverting a generated sample")

    syn_log_path = log_dir(config) + "_syn"
    os.makedirs(syn_log_path, exist_ok=True)

    seed = config.get("seed", 0) + 7
    with torch.no_grad():
        film0 = gen_model.get_mapping(torch.randn(
            1, gen_model.cfg.z_dim, device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed)))[0]
    code = FilmCode(film0)
    opt = common.adam(code.parameters(), 1e-4)
    state = common.init_state({"film": code}, opt)
    global_step, state = common.resume(syn_log_path, state)

    step_fn = make_syn_step(gen_model, disc, target, code, opt)
    loss_log = []
    loss_file = os.path.join(syn_log_path, "syn_loss.npy")
    if global_step and os.path.exists(loss_file):
        # the history must span the whole run across restarts; truncate a
        # log that ran ahead of the restored checkpoint
        loss_log = [float(v) for v in np.load(loss_file)][:global_step]
    n_pose = 9
    poses = [(0.15 * (i - (n_pose - 1) / 2), 0.0) for i in range(n_pose)]
    iterations = config.get("syn_iterations", ITERATIONS)
    step_gen = torch.Generator(device=dev)

    watchdog = diagnostics.watchdog_from_config(config, syn_log_path)
    while global_step < iterations:
        watchdog.beat(f"step {global_step}")
        step_gen.manual_seed(seed * 1_000_003 + global_step + 1)
        loss_log.append(step_fn(generator=step_gen)["loss"])
        global_step += 1
        state["step"] = global_step
        if global_step % I_PRINT == 0:
            loss_log[:] = flush_scalar_list(loss_log)
            print(f"[Train] Iter: {global_step} loss: {loss_log[-1]}")
        if global_step % I_SAVE == 0:
            # the sidecar before the checkpoint: resume truncates a log
            # that ran ahead, but could not fill one left behind
            loss_log[:] = flush_scalar_list(loss_log)
            np.save(loss_file, np.asarray(loss_log, np.float64))
            p = ckpt_lib.save(syn_log_path, global_step,
                              common.state_dict(state))
            print(f"Saved checkpoints at {p}")
        if global_step % I_IMAGE == 0:
            demo_multiview(gen_model, os.path.join(
                syn_log_path, f"{global_step:06d}.png"), poses,
                film=code.film.detach()[None], resolution=RESOLUTION,
                seed=10_000_001)

    # the watchdog stays armed through the final flush, multiview and orbit
    watchdog.beat("final flush")
    loss_log[:] = flush_scalar_list(loss_log)
    # final 128^2 multiview and orbit GIF (ref: synthesis.py:131-139)
    film = code.film.detach()[None]
    watchdog.beat("final multiview")
    demo_multiview(gen_model, os.path.join(syn_log_path, "demo.png"), poses,
                   film=film, resolution=FINAL_RES, coarse=FINAL_COARSE,
                   fine=FINAL_FINE, seed=10_000_002, beat=watchdog.beat)
    orbit = [(a, 0.0) for a in np.linspace(-1, 1, 41)[:-1]]
    demo_video(gen_model, os.path.join(syn_log_path, "demo.gif"), orbit,
               film=film, resolution=FINAL_RES, coarse=FINAL_COARSE,
               fine=FINAL_FINE, seed=10_000_003, beat=watchdog.beat)
    watchdog.stop()
    return {"film": code.film.detach(), "loss_log": loss_log,
            "target": target, "log_path": syn_log_path}


def main(argv=None):
    argv, device = split_device_flag(argv if argv is not None
                                     else sys.argv[1:])
    config = common.parse_cli(argv[:1], PIGAN_TRAIN_DEFAULTS)
    target = argv[1] if len(argv) > 1 else None
    return synthesize(config, target, device)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""End-to-end pi-GAN validation for the PyTorch/CUDA port (the counterpart
of tools/validate_pigan.py): does the generator learn the data
distribution, and do its samples stay 3D-consistent?

Trains ``train_pigan.train`` (on CUDA: K8 forward in fp32 and K7 backward,
the default trunk mode 1) on the synthetic shaded-blob dataset and checks,
before vs after training, the JAX tool's gates as written there:
  * the colour-histogram distance to the dataset shrinks by >= 34%,
  * the random-conv and trained-D Frechet distances halve, and the
    trained-D one lands under 30x the real-vs-real floor,
  * the samples stay diverse (std across the batch > 0.02), also over the
    second half of the checkpoints (no late collapse),
  * low-frequency within-image structure >= 40% of the data's,
  * the same latent at two nearby yaws differs, but little (3D
    consistency), and the losses stay finite and bounded.
Exit code 0 on PASS, 1 on FAIL; ``main`` also returns every reading.

Run: python3 tools/torch_validate_pigan.py [iterations] [stage1_iters]
         [fade] [batch0] [data_n] [--resume] [--fresh] [--face|--bigface]
         [--noise S] [--dlr LR] [--floor S] [--margin M] [--aug POLICY]
         [--nonsat] [--zdim Z] [--name NAME] [--device cpu]
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from msra_practice_project_tpu_torch import resolve_device  # noqa: E402
from msra_practice_project_tpu_torch.core import ckpt as ckpt_lib  # noqa: E402
from msra_practice_project_tpu_torch.core import image_io  # noqa: E402
from msra_practice_project_tpu_torch.core.artifacts import (  # noqa: E402
    run_dir)
from msra_practice_project_tpu_torch.core.config import (  # noqa: E402
    PIGAN_TRAIN_DEFAULTS, resolve)
from msra_practice_project_tpu_torch.core.diagnostics import (  # noqa: E402
    Watchdog)
from msra_practice_project_tpu_torch.core.metrics import (  # noqa: E402
    feature_distance, frechet_from_features)
from msra_practice_project_tpu_torch.data.image_folder import (  # noqa: E402
    ImageFolder)
from msra_practice_project_tpu_torch.eval import pigan_test  # noqa: E402
from msra_practice_project_tpu_torch.eval.pigan_demo import (  # noqa: E402
    DEMO_COARSE, DEMO_FINE, _grid, save_demo)
from msra_practice_project_tpu_torch.models import pigan  # noqa: E402
from msra_practice_project_tpu_torch.train import train_pigan  # noqa: E402

# the high-resolution sample grid (demo mode 0's form) and its samples
DEMO_RES, DEMO_SAMPLES = 128, (DEMO_COARSE, DEMO_FINE)
SAMPLE_SEED = 42


def color_hist(imgs, bins=16):
    """imgs [N, H, W, 3] in [0,1] -> normalised per-channel histogram."""
    hs = []
    for c in range(3):
        h, _ = np.histogram(imgs[..., c], bins=bins, range=(0, 1),
                            density=True)
        hs.append(h / bins)
    return np.concatenate(hs)


def lowfreq_spatial_std(imgs, pool=4):
    """Within-image spatial std after pool x pool mean-pooling: pooling
    kills iid speckle (std / pool) while genuine blob or face structure
    survives, so this is the gated form of the raw spatial std."""
    imgs = np.asarray(imgs)
    n, h, w, c = imgs.shape
    p = imgs[:, :h - h % pool, :w - w % pool, :]
    p = p.reshape(n, h // pool, pool, w // pool, pool, c).mean(axis=(2, 4))
    return float(p.std(axis=(1, 2)).mean())


def center_corner_contrast(imgs, frac=4):
    """Mean |center-patch colour - corner-patch colour| per image: a
    head-formation detector for the face datasets (fog and mottled colour
    fields score ~0 whatever their variance)."""
    imgs = np.asarray(imgs)
    h, w = imgs.shape[1:3]
    ph, pw = h // frac, w // frac
    center = imgs[:, (h - ph) // 2:(h + ph) // 2,
                  (w - pw) // 2:(w + pw) // 2, :].mean(axis=(1, 2))
    corners = np.stack([
        imgs[:, :ph, :pw, :].mean(axis=(1, 2)),
        imgs[:, :ph, -pw:, :].mean(axis=(1, 2)),
        imgs[:, -ph:, :pw, :].mean(axis=(1, 2)),
        imgs[:, -ph:, -pw:, :].mean(axis=(1, 2)),
    ]).mean(axis=0)
    return float(np.abs(center - corners).mean())


def corner_patches(imgs, frac=8):
    """[N, 4*ph, pw, 3] stack of the four h//frac corner patches."""
    imgs = np.asarray(imgs)
    h, w = imgs.shape[1:3]
    ph, pw = h // frac, w // frac
    return np.concatenate([
        imgs[:, :ph, :pw, :], imgs[:, :ph, -pw:, :],
        imgs[:, -ph:, :pw, :], imgs[:, -ph:, -pw:, :]], axis=1)


def corner_background_error(imgs, bg, frac=8):
    """Mean |corner-patch pixel - bg| per image, ``bg`` the median of the
    real batch's own corner pixels: a generator that forms heads must also
    form the background behind them."""
    return float(np.abs(corner_patches(imgs, frac) - bg).mean())


def decide_resume(exp_dir, resume=False, fresh=False):
    """Restart-safe resume decision: checkpoints in the durable experiment
    directory mean resume, unless ``--fresh`` asks for a wipe on the first
    supervised attempt; ``SUPERVISE_ATTEMPT`` > 1 (a watchdog restart)
    always resumes."""
    attempt = int(os.environ.get("SUPERVISE_ATTEMPT", "1"))
    # --fresh is honoured only on the first attempt: a supervisor replays
    # the same argv on every restart
    if fresh and attempt == 1:
        return False
    if attempt > 1:
        return True
    if resume:
        return True
    if os.path.isdir(exp_dir):
        if ckpt_lib.list_checkpoints(exp_dir):
            print(f"[validate] checkpoints found in {exp_dir} — "
                  "auto-resuming (pass --fresh to wipe and restart)")
            return True
    return False


@torch.no_grad()
def sample(gen_model, seed, n, res):
    """n images ``[n, res, res, 3]`` (numpy) of latents, prior poses and
    jitter drawn from a generator seeded with ``seed``, and their film
    codes."""
    dev = next(gen_model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(n, gen_model.cfg.z_dim, generator=gen, device=dev)
    film = gen_model.get_mapping(z)
    theta, phi = gen_model.sample_poses(n, gen, dev)
    imgs = gen_model.render_film(film, theta, phi, res, generator=gen)
    return imgs.cpu().numpy(), film


def _warn_config_drift(saved_cfg_path, cfg):
    """Resuming under another config than the saved one mixes two runs:
    say so loudly (iterations may legitimately grow)."""
    if not os.path.exists(saved_cfg_path):
        return
    with open(saved_cfg_path) as f:
        saved = json.load(f)
    drift = {k: (saved.get(k), dict(cfg).get(k))
             for k in set(saved) | set(dict(cfg))
             if saved.get(k) != dict(cfg).get(k)}
    if drift:
        print("[validate] *** WARNING: resuming with a DIFFERENT "
              "config than the saved run ***")
        for k, (old, new) in sorted(drift.items()):
            print(f"[validate] ***   {k}: saved {old!r} -> relaunch {new!r}")
        print("[validate] *** gates will score a mixed-config run; "
              "use --fresh or a new experiment name if unintended")


def main(iterations=1200, stage1_iters=0, fade=200, batch0=16, data_n=128,
         resume=False, variant="shaded", noise=0.0, dlr=None, floor=0.0,
         margin=None, augment="", fresh=False, nonsat=False, zdim=256,
         exp_name=None, device=None, overrides=None) -> dict:
    """The single-stage gate (``stage1_iters`` 0) or the two-stage
    progressive schedule (32^2, a ``fade``-iteration fade-in, 64^2 for
    ``stage1_iters``); gates at the final stage's resolution.  Runs on CUDA
    unless ``device='cpu'``; ``overrides`` replaces training-config keys
    (used by the CPU test to run at a tiny size).  Returns every reading,
    with ``pass`` the verdict and ``exp_dir`` the experiment directory."""
    device = resolve_device(device)
    two_stage = stage1_iters > 0
    # the durable root (default <repo>/runs, MSRA_TPU_RUN_ROOT overrides)
    base = run_dir("pigan_validate")
    name = exp_name or (("exp2" if two_stage else "exp") +
                        ("" if variant == "shaded" else f"_{variant}"))
    exp_dir = os.path.join(base, name)
    resume = decide_resume(exp_dir, resume, fresh)
    if not resume:
        shutil.rmtree(exp_dir, ignore_errors=True)
    if two_stage:
        schedule = {
            "iterations": [iterations, iterations + stage1_iters],
            "fade_in_itrs": [0, fade],
            "batch_size": [batch0, 16], "resolution": [32, 64],
        }
    else:
        schedule = {
            "iterations": [iterations], "fade_in_itrs": [0],
            "batch_size": [batch0], "resolution": [32],
        }
    total = schedule["iterations"][-1]
    cfg = resolve({
        "output_path": base, "experiment_name": name,
        "data_path": "/nonexistent", "z_dim": zdim,
        "render_coarse_sample_num": 8, "render_fine_sample_num": 16,
        # i_save bounds what a restart replays (capped at 2500)
        "i_print": max(min(total // 5, 2500), 1),
        "i_save": max(min(total // 10, 2500), 1),
        "i_image": total, "data_n": data_n, "data_variant": variant,
        "watchdog_timeout": 1200,
        # annealed instance noise, optionally to a floor
        "instance_noise": noise,
        "instance_noise_anneal": max(total // 2, 1),
        "instance_noise_floor": floor,
        # --margin: skip D updates while E[D(fake)] exceeds it
        **({} if margin is None else {"d_skip_margin": margin}),
        # --aug: DiffAugment on real and fake before D
        **({} if not augment else {"diff_augment": augment}),
        # --nonsat: the non-saturating G loss
        **({"g_nonsat": True} if nonsat else {}),
        **schedule,
        # --dlr scales D's lr down (end lr at the reference's 4:1 ratio)
        **({} if dlr is None else {"discriminator_lr": dlr,
                                   "discriminator_lr_end": dlr / 4.0}),
        **(overrides or {}),
    }, PIGAN_TRAIN_DEFAULTS)
    res = cfg["resolution"][-1]
    if resume:
        _warn_config_drift(os.path.join(exp_dir, "config.json"), cfg)

    # the untrained reference point, with its own watchdog (as the phases
    # after training): a wedged device exits 17 for a supervised restart
    gen_cfg = pigan.GeneratorConfig(
        z_dim=zdim, resolution=res, near=cfg.render_near, far=cfg.render_far,
        coarse_samples=cfg.render_coarse_sample_num,
        fine_samples=cfg.render_fine_sample_num)
    dog = Watchdog(1800.0)
    g0 = pigan.Generator(gen_cfg, generator=torch.Generator().manual_seed(
        0)).to(device)
    samples0, _ = sample(g0, SAMPLE_SEED, 32, res)
    dog.stop()

    out = train_pigan.train(cfg, device=device)
    generator = out["generator"]
    dog = Watchdog(900.0)
    samples1, film = sample(generator, SAMPLE_SEED, 32, res)

    # the dataset at the final stage's resolution
    ds = ImageFolder(os.path.join(exp_dir, "_synthetic_faces"), 64,
                     resize=res / 64.0, device=device)
    _, _, real = ds.get()
    real_np = real.cpu().numpy()
    h_real = color_hist(real_np)
    d0 = np.abs(color_hist(samples0) - h_real).mean()
    d1 = np.abs(color_hist(samples1) - h_real).mean()
    diversity = samples1.std(axis=0).mean()
    # random-conv Frechet: a generator matching only colour statistics
    # does not close it
    f0 = feature_distance(samples0, real_np)
    f1 = feature_distance(samples1, real_np)
    # trained-D Frechet: features D learned while separating real from
    # fake, against a real-vs-real floor under the same embedding
    d_model = out["discriminator"]

    @torch.no_grad()
    def d_embed(imgs):
        x = torch.as_tensor(imgs, device=device).permute(0, 3, 1, 2)
        return d_model.apply_features(x.contiguous(), res).cpu().numpy()

    ef_real = d_embed(real_np[:64])
    fd0 = frechet_from_features(d_embed(samples0), ef_real)
    fd1 = frechet_from_features(d_embed(samples1), ef_real)
    real_heldout = real_np[64:128]
    if len(real_heldout) < 8:  # small datasets: reuse a shifted slice
        real_heldout = real_np[max(len(real_np) // 2, 1):]
    fd_floor = frechet_from_features(d_embed(real_heldout), ef_real)
    # per-image spatial structure (flat-field collapse), and its pooled,
    # speckle-proof form, which is what gates
    spatial_real = float(real_np.std(axis=(1, 2)).mean())
    spatial0 = float(samples0.std(axis=(1, 2)).mean())
    spatial1 = float(samples1.std(axis=(1, 2)).mean())
    lf_real = lowfreq_spatial_std(real_np)
    lf1 = lowfreq_spatial_std(samples1)
    # visual evidence beside the numbers
    image_io.imwrite(os.path.join(exp_dir, "samples_final.png"),
                     _grid(samples1[:32].reshape(4, 8, res, res, 3)))
    image_io.imwrite(os.path.join(exp_dir, "samples_real.png"),
                     _grid(real_np[:32].reshape(4, 8, res, res, 3)))
    save_demo(generator, os.path.join(exp_dir, f"demo_{DEMO_RES}.png"),
              4, 8, DEMO_RES, *DEMO_SAMPLES,
              generator=torch.Generator(device=device).manual_seed(77),
              beat=dog.beat)
    stage_txt = (f"two-stage 32^2 -> fade {fade} -> 64^2"
                 if two_stage else f"single stage {res}^2")
    print(f"[validate] schedule: {stage_txt}; gates at {res}^2")
    print(f"[validate] hist distance untrained {d0:.4f} -> trained {d1:.4f}")
    print(f"[validate] feature (rf-frechet) untrained {f0:.4f} -> "
          f"trained {f1:.4f}")
    print(f"[validate] trained-D feature frechet untrained {fd0:.4f} -> "
          f"trained {fd1:.4f} (real-vs-real floor {fd_floor:.4g}; "
          f"trained = {fd1 / max(fd_floor, 1e-9):.1f}x floor, bar 30x)")
    print(f"[validate] sample diversity (std across batch): {diversity:.4f}")
    print(f"[validate] within-image spatial std: real {spatial_real:.4f}, "
          f"untrained {spatial0:.4f} -> trained {spatial1:.4f} "
          "(flat-field collapse if << real)")
    print(f"[validate] LOW-FREQ spatial std (4x pooled): real {lf_real:.4f}"
          f" -> trained {lf1:.4f} (speckle scores ~0 here)")
    readings = {}
    cc_ok = True
    if variant in ("face", "bigface"):
        cc_real = center_corner_contrast(real_np)
        cc1 = center_corner_contrast(samples1)
        cc_ok = bool(cc1 > 0.50 * cc_real)
        print(f"[validate] center-corner contrast (head formation): real "
              f"{cc_real:.4f} -> trained {cc1:.4f} (fog scores ~0; "
              f"gate >50% of real: {'ok' if cc_ok else 'FAIL'})")
        bg = float(np.median(corner_patches(real_np)))
        cbe_real = corner_background_error(real_np, bg)
        cbe1 = corner_background_error(samples1, bg)
        cbe_ok = bool(cbe1 < 2.0 * cbe_real)
        cc_ok = cc_ok and cbe_ok
        print(f"[validate] corner-background formation error (bg "
              f"{bg:.3f}): real {cbe_real:.4f} -> trained {cbe1:.4f} "
              f"(gate <2x real: {'ok' if cbe_ok else 'FAIL'})")
        readings.update(cc_real=cc_real, cc=cc1, cbe_real=cbe_real,
                        cbe=cbe1)

    # long-horizon stability: finite losses, no late divergence, and no
    # collapse of the diversity over the saved checkpoints
    loss_log = out["loss_log"]
    g_arr = np.asarray(loss_log["g_loss"])
    d_arr = np.asarray(loss_log["d_loss"])
    finite = bool(np.isfinite(g_arr).all() and np.isfinite(d_arr).all())
    g_tail = float(np.abs(g_arr[-max(total // 10, 1):]).mean())
    tail_ok = bool(g_tail < 50.0)
    print(f"[validate] losses finite: {finite}; |g_loss| tail mean "
          f"{g_tail:.2f}")

    steps = [s for s, _ in ckpt_lib.list_checkpoints(exp_dir)]
    g_ckpt = copy.deepcopy(generator)
    div_traj, evo_rows = [], []
    for s in steps:
        dog.beat(f"ckpt {s}")
        g_ckpt.load_state_dict(ckpt_lib.restore(
            ckpt_lib.ckpt_path(exp_dir, s), map_location=device)["g"])
        # mid-run checkpoints may be from an earlier stage: sample at res
        samp, _ = sample(g_ckpt, SAMPLE_SEED * 1000 + 100 + s, 16, res)
        div_traj.append(float(samp.std(axis=0).mean()))
        evo_rows.append(samp[:8])
    del g_ckpt
    # mode collapse is a late-phase failure: gate the second half of the
    # trajectory (transient dips early in a short run recover)
    late = div_traj[len(div_traj) // 2:]
    no_collapse = bool(min(late) > 0.02) if late else True
    print(f"[validate] diversity trajectory over ckpts {steps}: "
          f"{[round(v, 3) for v in div_traj]} "
          f"(no LATE collapse over the final {len(late)}: {no_collapse})")
    if evo_rows:
        image_io.imwrite(os.path.join(exp_dir, "ckpt_evolution.png"),
                         _grid(np.stack(evo_rows)))

    curves = pigan_test.plot_loss_curves(
        loss_log, os.path.join(exp_dir, "loss_curves.png"))
    if curves:
        print(f"[validate] loss curves -> {curves}")

    # 3D consistency: the same identity at two nearby yaws
    th = torch.tensor([0.0, 0.25], device=device)
    ph = torch.zeros(2, device=device)
    with torch.no_grad():
        pair = generator.render_film(
            film[:1].repeat(2, 1, 1), th, ph, res,
            generator=torch.Generator(device=device).manual_seed(9))
    pair = pair.cpu().numpy()
    delta = float(np.abs(pair[0] - pair[1]).mean())
    dog.stop()
    print(f"[validate] yaw-shift mean pixel delta: {delta:.4f} "
          "(0 = 2D collapse, large = view-inconsistent)")

    spatial_ok = lf1 > 0.4 * lf_real
    fd_ok = (fd1 < 0.5 * fd0) and (fd1 < 30.0 * fd_floor)
    ok = (d1 < 0.66 * d0) and (f1 < 0.5 * f0) and fd_ok \
        and diversity > 0.02 \
        and 1e-4 < delta < 0.3 and finite and tail_ok and no_collapse \
        and spatial_ok and cc_ok
    print("[validate]", "PASS" if ok else "FAIL",
          "(hist improves >=34%, rf-frechet improves >=50%, trained-D "
          "frechet improves >=50% AND <30x real-vs-real floor, diverse "
          "samples, LOW-FREQ spatial structure >=40% of real, head "
          "contrast >=50% of real + corner-background <2x real on face "
          "variants, view-consistent, losses stable, no collapse)")
    readings.update(
        hist0=float(d0), hist1=float(d1), rf_frechet0=float(f0),
        rf_frechet1=float(f1), d_frechet0=float(fd0), d_frechet1=float(fd1),
        d_frechet_floor=float(fd_floor), diversity=float(diversity),
        spatial_real=spatial_real, spatial0=spatial0, spatial1=spatial1,
        lowfreq_real=lf_real, lowfreq1=lf1, finite=finite, g_tail=g_tail,
        div_traj=div_traj, ckpt_steps=steps, no_collapse=no_collapse,
        yaw_delta=delta, spatial_ok=bool(spatial_ok), fd_ok=bool(fd_ok),
        cc_ok=cc_ok, exp_dir=exp_dir, resolution=res,
        iterations=total, loss_log=loss_log)
    readings["pass"] = bool(ok)
    return readings


def _pop_flag(raw, flag, cast):
    """(raw without ``flag VALUE``, cast(VALUE) or None)."""
    if flag not in raw:
        return raw, None
    i = raw.index(flag)
    return raw[:i] + raw[i + 2:], cast(raw[i + 1])


def cli(argv) -> dict:
    raw = list(argv)
    raw, noise = _pop_flag(raw, "--noise", float)
    raw, dlr = _pop_flag(raw, "--dlr", float)
    raw, floor = _pop_flag(raw, "--floor", float)
    raw, margin = _pop_flag(raw, "--margin", float)
    raw, augment = _pop_flag(raw, "--aug", str)
    raw, zdim = _pop_flag(raw, "--zdim", int)
    raw, exp_name = _pop_flag(raw, "--name", str)
    raw, device = _pop_flag(raw, "--device", str)
    switches = ("--resume", "--face", "--bigface", "--fresh", "--nonsat")
    argv = [a for a in raw if a not in switches]
    variant = ("bigface" if "--bigface" in raw
               else "face" if "--face" in raw else "shaded")
    ints = [int(a) for a in argv[:5]]
    defaults = [1200, 0, 200, 16, 128]
    its, s1, fade, batch0, data_n = ints + defaults[len(ints):]
    return main(its, s1, fade, batch0, data_n, "--resume" in raw, variant,
                0.0 if noise is None else noise, dlr,
                0.0 if floor is None else floor, margin, augment or "",
                "--fresh" in raw, "--nonsat" in raw,
                256 if zdim is None else zdim, exp_name, device)


if __name__ == "__main__":
    sys.exit(0 if cli(sys.argv[1:])["pass"] else 1)

#!/usr/bin/env python3
"""Reference-scale NeRF soak for the PyTorch/CUDA port (the counterpart of
tools/soak_nerf.py): the long schedule through the real CLI, with a kill
and a resume in the middle, then the eval sweep and the analysis plots.

It mirrors the reference's canonical experiment (nerf/train_nerf.py:31,
200,000 iterations; configs/lego.json; i_save 10,000, i_image 1,000) on the
hard analytic scene at 400^2 frames, 50 train views, on CUDA through K1 and
K2 (the fused bf16 kernels).

Phases:
  A. train via ``python -m msra_practice_project_tpu_torch.train.train_nerf
     <cfg>`` until the first checkpoint at or past ``kill_frac *
     iterations``, then SIGKILL the process mid-epoch (no clean shutdown).
  B. relaunch the same CLI under tools/supervise.py: it must resume from
     the latest checkpoint (the exact resume: replayed epoch permutations
     and the batch cursor) and run to completion.  Its wall time gives
     rays/s, start-up, eval images and checkpoints included.
  C. ``eval.test_nerf`` over every train and val view (PSNR, SSIM,
     perceptual distance -> test.json and test.jpg), supervised, and
     ``eval.analysis_view``, both as CLIs; then one val view rendered again
     in this process and timed alone (the eval render at the soak's size).

The merged log.npy must span every iteration.  The gate, the JAX tool's:
novel-view ("in", else train) PSNR > 28 dB, printed (the exit code is 0
either way, as the JAX tool's).  The last line is a JSON object of the
readings.

``i_save`` (default 10,000, the defaults' own) is an argument, so that a
short schedule has a checkpoint to resume from; ``--poll`` (10 s) and
``--settle`` (20 s, the wait after the checkpoint is seen, to land past the
save) are the tool's pace, not the run's.

Run: python3 tools/torch_soak_nerf.py [iterations] [size] [n_train]
         [--i-save N] [--poll S] [--settle S] [--device cpu]
     (defaults 200000 / 400 / 50: the reference's eval geometry, resize 0.5
     of 800^2)
Artifacts: <run root>/nerf_soak/soak_<iterations>/ (runs/ by default,
MSRA_TPU_RUN_ROOT overrides).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from msra_practice_project_tpu_torch import resolve_device  # noqa: E402
from msra_practice_project_tpu_torch.core import ckpt as ckpt_lib  # noqa: E402
from msra_practice_project_tpu_torch.core.artifacts import (  # noqa: E402
    run_dir)

PASS_DB = 28.0


def latest_ckpt_step(log_dir) -> int:
    last = ckpt_lib.latest(log_dir)
    return last[0] if last else 0


@contextlib.contextmanager
def in_repo():
    """The working directory at the repo root for the block: the CLIs run
    as ``python -m`` modules of the port, and tools/supervise.py starts
    them without a cwd of their own."""
    old = os.getcwd()
    os.chdir(REPO)
    try:
        yield
    finally:
        os.chdir(old)


def checkpoint_stamps(log_dir) -> dict:
    """{checkpoint path: mtime in ns}: a run that resumes leaves the
    checkpoints before its start untouched; one that starts afresh writes
    them again."""
    return {p: os.stat(p).st_mtime_ns
            for _, p in ckpt_lib.list_checkpoints(log_dir)}


def check_resumed(log_dir, stamps) -> None:
    """Raises unless every checkpoint in ``stamps`` (taken after the kill)
    is still there, untouched: the relaunched run resumed."""
    after = checkpoint_stamps(log_dir)
    if any(after.get(p) != t for p, t in stamps.items()):
        raise RuntimeError("phase B rewrote phase A's checkpoints: it did "
                           "not resume")


def kill_after_checkpoint(cli, log_dir, kill_step, poll, settle, tag):
    """Phase A: run ``cli`` until ``log_dir`` holds a checkpoint at or past
    ``kill_step``, wait ``settle`` seconds, SIGKILL it.  A watchdog exit
    (tools/supervise.WATCHDOG_EXIT) relaunches it after ``settle`` (the
    run resumes from its checkpoint); any other early exit raises.
    Returns (the step it will resume from, wall seconds)."""
    from tools.supervise import WATCHDOG_EXIT

    t0 = time.time()
    proc = subprocess.Popen(cli, cwd=REPO)
    try:
        while True:
            time.sleep(poll)
            if proc.poll() is not None:
                if proc.returncode == WATCHDOG_EXIT:
                    print(f"[{tag}] phase A watchdog stall; restarting",
                          flush=True)
                    time.sleep(settle)
                    proc = subprocess.Popen(cli, cwd=REPO)
                    continue
                raise RuntimeError(f"phase A exited early "
                                   f"rc={proc.returncode}")
            if latest_ckpt_step(log_dir) >= kill_step:
                time.sleep(settle)  # land mid-epoch, past the save
                break
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
    return latest_ckpt_step(log_dir), time.time() - t0


def time_eval_view(log_dir, device) -> float:
    """Seconds of one val view's render at the experiment's size with its
    plain models (as eval.test_nerf renders it), after one warm-up
    render; the device is synchronised around it."""
    from msra_practice_project_tpu_torch.eval.nerf_common import (
        generator_for, load_experiment, render_view)
    from msra_practice_project_tpu_torch.train.train_nerf import load_dataset

    config, models, _, _ = load_experiment(log_dir, device=device)
    images, poses, width, height, focal, _ = load_dataset(config)
    pose = (poses["val"]["in"] if len(poses["val"]["in"])
            else poses["train"])[0]
    generator = generator_for(models)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    render_view(config, models, width, height, focal, pose, generator)
    sync()
    t0 = time.perf_counter()
    render_view(config, models, width, height, focal, pose, generator)
    sync()
    return time.perf_counter() - t0


def main(iterations=200000, size=400, n_train=50, kill_frac=0.25,
         i_save=10000, poll=10.0, settle=20.0, device=None,
         overrides=None) -> dict:
    """The soak; ``overrides`` replaces keys of the run's config (smaller
    runs).  Raises when phase A ends before the kill, phase B does not
    resume (it rewrote an earlier checkpoint) or fails, or the log does
    not span the run.  Returns the readings (the summary by split, the
    kill and resume steps, the PSNR around the kill, seconds, rays/s,
    ``pass``)."""
    from tools.supervise import supervise
    from tools.torch_validate_nerf import make_dataset

    device = resolve_device(device)
    base = run_dir("nerf_soak")
    data_dir = os.path.join(base, f"data_hard_{size}")
    if not os.path.exists(os.path.join(data_dir, "transforms_train.json")):
        print(f"[soak] rendering hard analytic dataset at {size}^2, "
              f"{n_train} train views...", flush=True)
        t0 = time.time()
        make_dataset(data_dir, size, n_train=n_train, n_val=8, n_test=8,
                     scene="hard", device=device)
        print(f"[soak] dataset done in {time.time() - t0:.0f}s", flush=True)

    exp = f"soak_{iterations}"
    log_dir = os.path.join(base, exp)
    cfg = {
        "output_path": base, "experiment_name": exp,
        "data_path": data_dir, "data_resize": 1.0, "data_skip": 1,
        "iterations": iterations, "i_save": i_save,
        # a stalled run exits 17 after 15 minutes of silence instead of
        # hanging (core/diagnostics.Watchdog); tools/supervise.py restarts it
        "watchdog_timeout": 900,
        # everything else = NERF_TRAIN_DEFAULTS: batch 1024, 64+128 samples,
        # lr 5e-4 decay 500, start_up 500, i_print 100, i_image 1000,
        # steps_per_call 10
        **(overrides or {}),
    }
    cfg_file = os.path.join(base, f"{exp}_config.json")
    with open(cfg_file, "w") as f:
        json.dump(cfg, f, indent=2)
    batch = cfg.get("batch_size", 1024)

    dev_flag = ["--device", "cpu"] if device.type == "cpu" else []
    cli = [sys.executable, "-m",
           "msra_practice_project_tpu_torch.train.train_nerf", cfg_file,
           *dev_flag]
    kill_step = int(kill_frac * iterations)

    print(f"[soak] phase A: training until ckpt >= {kill_step}, then KILL",
          flush=True)
    print("[soak] $", " ".join(cli), flush=True)
    resume_step, wall_a = kill_after_checkpoint(cli, log_dir, kill_step,
                                                poll, settle, "soak")
    print(f"[soak] phase A killed after {wall_a:.0f}s at ckpt {resume_step}",
          flush=True)
    stamps = checkpoint_stamps(log_dir)

    # Phase B under the supervisor: a watchdog exit restarts onto the
    # checkpoint's auto-resume instead of aborting the soak.
    print("[soak] phase B: resume to completion (supervised)", flush=True)
    t_b = time.time()
    with in_repo():
        rc = supervise(cli)
    wall_b = time.time() - t_b
    if rc != 0:
        raise RuntimeError(f"phase B failed rc={rc}")
    check_resumed(log_dir, stamps)
    steps_b = iterations - resume_step
    rays_rate = steps_b * batch / wall_b
    print(f"[soak] phase B: {steps_b} steps in {wall_b:.0f}s wall "
          f"({rays_rate:,.0f} rays/s incl. init/eval-renders)", flush=True)

    # log continuity: the merged log.npy must span the whole run
    log = np.load(os.path.join(log_dir, "log.npy"),
                  allow_pickle=True).item()
    n_log = len(log["loss"])
    if n_log != iterations:
        raise RuntimeError(f"log.npy spans {n_log} of {iterations} steps")
    pre = log["psnr"][max(resume_step - 50, 0):resume_step]
    post = log["psnr"][resume_step:resume_step + 50]
    print(f"[soak] log spans {n_log} steps; psnr around the kill: "
          f"{np.mean(pre):.2f} -> {np.mean(post):.2f} dB (no reset)")

    # Phase C: the sweep inherits the experiment's watchdog and is
    # idempotent, so it is supervised too.
    print("[soak] phase C: eval sweep over all views (supervised)",
          flush=True)
    t_c = time.time()
    with in_repo():
        rc = supervise([sys.executable, "-m",
                        "msra_practice_project_tpu_torch.eval.test_nerf",
                        log_dir, str(iterations), *dev_flag])
    wall_c = time.time() - t_c
    if rc != 0:
        raise RuntimeError("test_nerf sweep failed")
    print("[soak] $ python -m msra_practice_project_tpu_torch.eval."
          "analysis_view", flush=True)
    r = subprocess.run([sys.executable, "-m",
                        "msra_practice_project_tpu_torch.eval.analysis_view",
                        os.path.join(log_dir, "analysis"), log_dir],
                       cwd=REPO)
    if r.returncode != 0:
        raise RuntimeError("analysis_view failed")
    view_s = time_eval_view(log_dir, device)

    with open(os.path.join(log_dir, "test.json")) as f:
        test = json.load(f)
    n_views = sum(len(test["psnr"][s]) for s in ("train", "in", "ex"))
    summary = {}
    for split in ("train", "in", "ex"):
        ps = test["psnr"][split]
        if ps:
            summary[split] = (float(np.mean(ps)),
                              float(np.mean(test["ssim"][split])))
    print("[soak] ===== SUMMARY =====")
    print(f"[soak] schedule: {iterations} iters, {size}^2 frames, "
          f"{n_train} train views, batch {batch}, "
          f"{cfg.get('render_coarse_sample_num', 64)}+"
          f"{cfg.get('render_fine_sample_num', 128)} samples")
    print(f"[soak] wall: phase A {wall_a:.0f}s (to step {resume_step}) + "
          f"phase B {wall_b:.0f}s + eval sweep {wall_c:.0f}s "
          f"({n_views} views, {wall_c / max(n_views, 1):.2f} s/view with "
          f"the CLI's start-up)")
    print(f"[soak] eval render at {size}^2: {view_s:.3f} s per view (one "
          "view, timed alone)")
    print(f"[soak] steady-state incl. overheads: {rays_rate:,.0f} rays/s")
    for split, (p, s) in summary.items():
        print(f"[soak] {split}: PSNR {p:.2f} dB SSIM {s:.4f}")
    print(f"[soak] artifacts: {log_dir}/test.json, test.jpg, "
          f"analysis_*.png, log.npy ({n_log} steps), "
          f"{len(ckpt_lib.list_checkpoints(log_dir))} checkpoints")
    ok = summary.get("in", summary.get("train"))[0] > PASS_DB
    print("[soak]", "PASS" if ok else "FAIL",
          f"(novel-view PSNR > {PASS_DB:g} dB)", flush=True)
    return {"iterations": iterations, "size": size, "n_train": n_train,
            "kill_step": kill_step, "resume_step": resume_step,
            "log_steps": n_log, "psnr_before_kill": float(np.mean(pre)),
            "psnr_after_kill": float(np.mean(post)),
            "summary": {k: {"psnr": p, "ssim": s}
                        for k, (p, s) in summary.items()},
            "wall_a_s": wall_a, "wall_b_s": wall_b, "sweep_s": wall_c,
            "sweep_views": n_views, "eval_view_s": view_s,
            "rays_per_s": rays_rate, "log_dir": log_dir, "pass": bool(ok)}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("iterations", nargs="?", type=int, default=200000)
    p.add_argument("size", nargs="?", type=int, default=400)
    p.add_argument("n_train", nargs="?", type=int, default=50)
    p.add_argument("--i-save", type=int, default=10000)
    p.add_argument("--poll", type=float, default=10.0)
    p.add_argument("--settle", type=float, default=20.0)
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: CUDA)")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args(sys.argv[1:])
    print(json.dumps(main(a.iterations, a.size, a.n_train,
                          i_save=a.i_save, poll=a.poll, settle=a.settle,
                          device=a.device)))

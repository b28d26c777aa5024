#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (msra_practice_project_tpu_torch) on
one NVIDIA GPU.

Phases; any failure exits non-zero:
  1. the card's name and power limit; build the CUDA kernels from the sources
     in this checkout, one nvcc per source, all started together; the
     built libraries' SASS (cuobjdump, or nvdisasm on a cubin) must hold
     HGMMA and no HMMA in the bf16 per-tile kernels of K7 and K8
     (film_mlp), of K1/K3/K6 and K2's delta chain, and in K4's bf16
     kernel (nerf_mlp: dx_tc_kernel), HGMMA on
     TF32 operands and no HMMA in K8's fp32 kernel (film_fwd_tf32_kernel)
     and in the NeRF forward's (nerf_fwd_tf32_kernel), and no HMMA
     anywhere in the NeRF library; each FiLM kernel that takes
     the trunk sine in both its instantiations (the polynomial and the
     exact sine, MSRA_TPU_FAST_SIN=0), and ptxas (-v) must report no stack
     frame and no spills for any of them;
The split-K dW pass that K2, K5 and K7 share (csrc/tile_mm.cuh):
  1b. hold it, launched alone, against its plain version: one CTA first
     (a 64 x 256 product over 64 points against torch.mm in fp32), then
     K2's task table at 65,536 and 196,608 points and K7's at 64 images of
     8,192 points, bf16 operands from a seed: dW/db within 5e-2 relative
     Frobenius norm per task (K2's gate), bitwise repeats, and the partials
     of a pass over the first half of the splits alone bitwise equal to the
     whole pass's;
NeRF (K1, K2):
  2. hold K1, K2 and K2's delta chain alone against their plain PyTorch
     versions at the coarse- and fine-pass shapes (65,536 and 196,608
     points), in fp32 and in bf16, and check that K2 and the chain are
     bitwise reproducible and that the chain alone writes the deltas K2
     returns;
  3. the NeRF path: `train_nerf.train` on the lego recipe (1024 rays, 64+128
     samples, full-width NeRF) for 30 iterations, 10 of them start-up, on the
     synthetic Blender scene; both kernels, K2's delta chain and its split-K
     pass must be launched twice per step, and the fused fp32 forward once
     per pass of the closing preview render (two PE models without
     autograd; counted by wrapping ops/render.render_rays).  Its last 20
     steps are one timed window (CUDA events): ms/step and rays/s;
  4. the same run again with torch.profiler (device activity only) on for
     its timed window: the device's busy time, the window's wall time and
     idle share, and the device time by kernel, all from that one window
     (the profiler's own host cost shows as the gap to phase 3's ms/step),
     the bf16 per-tile kernels (K1's, K2's delta chain) and the split-K pass
     by name in ms per step;
  4b. the NeRF quality gate: tools/torch_validate_nerf.py's main (the easy
     analytic scene rendered at 64x64 and trained for 3000 steps, the
     recipe of BASELINE.md's 37.5 dB) in this process; K1 and K2, K2's
     delta chain and its split-K pass must be launched twice per step, the
     fused fp32 forward once per pass of its renders of the trained field,
     and the held-out test views' PSNR must exceed 28 dB; then
     eval.test_nerf.run on the trained experiment (2 views per split):
     test.json with the JAX test_nerf's keys, lpips null, perceptual_metric
     "1-msssim";
  5. K1, K2 and K2's delta chain alone per launch at both shapes beside the
     plain version and the least time the card could take;
The rest of the fused NeRF MLP (K3, K6, K5, K4):
  6. hold K3 and K6 against their plain version at both shapes and at the
     roofline path's 262,144 points, fp32 and bf16, with K1's output gates;
     K3 must be bitwise equal to K1's output and K6 to K3;
  7. hold K5 (dW/db) and K4 (dx) against their plain versions at the same
     three shapes, fp32 and bf16, with need_dx False and True, on the same
     activations and deltas (K4 on both layouts it reads: K2's delta
     workspace and K5's copy) and end to end; K5's dW/db must be bitwise
     equal to K1 -> K2's, dx from K5 + K4 to dx from K2 + K4, two K5
     launches to each other, two K4 launches to each other and
     need_dx=False to need_dx=True;
  8. their path, tools/torch_roofline_nerf.py at batch 1024 in both modes
     (run in this process): the step's breakdown by stage, fused_nerf_apply
     at its defaults (forward K3 1, forward + backward K3 1, K5 1, K4 1 per
     call) and fwdwall (K6 launched);
  9. K3, K6, K5 and K4 per launch at both shapes beside the plain version
     and the least time the card could take, the card's name and power
     limit printed with them; K4 also at the roofline path's 262,144
     points, on K2's workspace, and beside a yardstick the port never
     calls: cuBLAS, one torch.matmul of K5's [N, 640] delta copy by the
     [640, 96] block matrix of the three PE weights (the products alone);
  9b. the fused fp32 forward (nerf_fwd_tf32_kernel: K3's function as
     3xTF32 products on wgmma, NeRFModel.forward's route without autograd
     on CUDA): ptxas reports no spills; at a 400x400 view tile's two passes
     (1,048,576 and 3,145,728 points) it holds 1e-4 of max|ref| against its
     plain version and against the plain model's fp32 forward, two
     launches are bitwise equal, and the model's forward returns the
     kernel's output; its time per launch beside its 3xTF32 bound, its
     plain version and the plain model's forward on cuBLAS; a 200x200
     render_image of two PE models launches it twice per tile, its rgb
     within 1e-4 (mean of the smallest 99% of gaps) of the plain models';
pi-GAN (K7, K8):
  10. hold K8 and K7 against their plain versions at the G step's two trunk
     shapes (64 images of 8,192 and of 24,576 points) and at 3 images of
     320 points (an odd number of 64-point tiles, so the last CTA's second
     warpgroup has none, and a CTA whose two tiles lie in two images), in
     fp32 and bf16, K7 with and without dx, and check that K7 and K8 are
     bitwise reproducible; K8 in fp32 is the 3xTF32 kernel
     (film_fwd_tf32_kernel);
  11. mode 1's trunk (K8 in fp32) on the points the generator's render_film
     feeds it at both stages of test.json (64 images of 32x32 pixels, 16 of
     64x64; coarse and fine pass) against the plain trunk on the same
     inputs, 1e-4 of max|ref|;
  12. the pi-GAN path: `train_pigan.train` on configs/pi_gan/test.json in
     the default trunk mode 1 (MSRA_TPU_FUSED_FILM unset: K8 forward in
     fp32, K7 backward) through both stages (iterations [20, 30], fade-in
     [0, 5]); K8 must be launched 4 times per iteration besides the demo
     grid's launches (counted around it), all in fp32, and K7 once: no
     plain trunk forward.
     Iterations 11-20 (stage 0) are one timed window: ms per iteration (a D
     step and a G step) and images/s;
  13. the same recipe in mode 2 (K8 forward in bf16, K7 backward), 8
     iterations of stage 0, the last 4 timed; K8 4 launches and K7 1 per
     iteration;
  14. both modes again for 6 iterations with torch.profiler on for the last
     3: busy, idle share and the time by kernel, K7's per-tile kernel and
     K8's kernel (fp32 in mode 1, bf16 in mode 2) by name, 4 K8 launches
     per iteration;
  15. K8 and K7 per launch at both shapes beside the plain version and the
     least time the card could take, and K8 in fp32 beside its plain
     version and its 3xTF32 bound;
  16. the split-K pass per launch at K2's two shapes and K7's coarse one,
     beside its plain version, the least time the card could take and a
     yardstick the port never calls: cuBLAS, one torch.mm (or column sum)
     per task.
The rest of pi-GAN (K8 and K7 at B = 1 image, the quality gate, eval,
mesh extraction and latent inversion):
  17. hold K8 and K7 against their plain versions at synthesis's shapes (1
     image of 64x64 pixels: 32,768 and 98,304 points), with phase 10's
     gates, K7's dfilm named; K8 alone on extract_mesh's grid slice (1 x
     65,536 points in the +-0.1 cube), fp32 and bf16, bitwise repeats;
     time both at B = 1 beside their plain versions and bounds;
  18. the pi-GAN quality gate: tools/torch_validate_pigan.py at its defaults
     (1200 iterations, batch 16 at 32x32, 128 shaded images, z 256, 8 + 16
     samples) in mode 1, in a temporary run root; its training must launch
     K8 in fp32 4 times and K7 once per iteration; the hist improvement
     >= 34%, diversity > 0.02, yaw delta in (1e-4, 0.3) and finite losses
     with |g| tail < 50 must hold; every reading and the tool's verdict
     (its Frechet, low-frequency and collapse gates included) are printed;
  19. on that experiment: eval.pigan_test.run, pigan_demo modes 0-6 (mode
     0 at 64x64, the rest at 128x128, 32 + 64 samples) and extract_mesh
     at n 256 (sigma grid: one fp32 K8 launch per slice, 256 in all; then
     marching at level -20), seconds each, K8 only and in fp32;
  20. train.synthesis on its checkpoint: self-inversion of a generated
     sample for 1000 steps (the JAX default is 5000), K8 in fp32 4 times
     and K7 twice per step, ms per step (CUDA events per step), and steps
     501-520 with torch.profiler on: busy, idle share and the time by
     kernel; every logged loss finite and the mean of the last 100 below
     the first 100's; then the final 128x128 multiview and the 40-frame
     orbit GIF, seconds each.
The SIREN stack (no kernel: the JAX package runs these MLPs as plain XLA,
the port as plain PyTorch in strict fp32), every counter set to 0 first:
  21. train_img at each kind's config (siren, tanh, relu, relu_pe: batch
     65,536 on the 256x256 synthetic image, 3 x 256, lr 1e-4), 10 + 100
     steps: ms/step over the last 100 (CUDA events), pixels/s, peak device
     memory; the loss must be finite and fall, the PNG and checkpoint
     written;
  22. train_sdf at siren_sdf_1.json's recipe (65,536 on- + 65,536
     off-surface points of the 100,000-point synthetic sphere), siren and
     relu_pe, 5 + 50 steps: ms/step, peak memory; then the final mesh (n
     512 for siren, 128 for relu_pe, whose untrained field crosses zero in
     most voxels): the SDF grid's and the marching's seconds, vertices;
  23. train_nerf.train at lego_siren.json's recipe (the SIREN NeRF, 1024
     rays x 64 + 128 samples), 30 steps, the last 20 timed, then again with
     torch.profiler on for them: ms/step, rays/s, busy, idle share, GEMM
     vs the rest; the loss must be finite and fall (mean of the last 5
     below the first 5's);
     profiles of the image and the SDF step (siren kind): busy, idle
     share, GEMM vs the rest; the sine alone (forward + backward at
     [65,536, 256]) and its share of the device time;
     no kernel of the port (K1-K8, K2's chain, the split-K pass) may have
     launched;
  24. tools/torch_validate_img.py 1500 (siren > 40 dB, relu_pe > 28 dB)
     and tools/torch_validate_sdf.py 4000 (mean |r - 0.6| < 1 voxel, p95 <
     3), in this process, with no kernel launch; then
     tools/torch_validate_img.py 3000 --real (the repo's copy of
     grace_hopper.jpg, siren > 28 dB, relu_pe > 23 dB); then eval.test_img
     and eval.test_sdf on their runs.  The SDF
     gate's --real (4000 steps) runs by hand.  The SIREN NeRF gate
     (tools/torch_validate_nerf.py 5000 64 --siren) runs by hand: at ~115
     ms a step it would take this run past 900 s.
Operations and scale-out (tools/torch_dp_check.py, run as a child process;
its own docstring has the details):
  25. data parallelism on the one card over two gloo ranks (NCCL refuses
     two ranks on one device): 3 lego-recipe NeRF steps through K1/K2 (512
     rays a rank) and 2 pi-GAN iterations at test.json's stage 0 in mode 1
     (32 latents a rank, K8 in fp32 and K7), their averaged gradients
     within 5e-2 relative Frobenius norm and losses within 1e-3 of one
     process at the same weights, the launches counted on each rank, a
     second NeRF run equal bitwise; a 100x100 eval view split over the
     ranks equal bitwise to one process's render; a one-rank NCCL group's NeRF
     step equal bitwise to a process without a group; the package's dry
     run (dryrun.dryrun_multichip) over two gloo ranks on the card;
  26. exact resume: train_nerf on the lego recipe, 20 steps against 10 and
     a resumed 10, losses and weights equal bitwise;
  27. profile_steps' trace names K1's and K2's kernels; debug_nans is
     silent on a clean run and raises on a NaN-poisoned batch.
The exact trunk sine (MSRA_TPU_FAST_SIN=0: torch.sin in the plain versions,
the kernels' exact-sine instantiations on the card):
  28. the device sines (film_sin_eval) against a double sin and cos on 2^24
     uniform points of |v| <= 3e3 (exact: max abs error <= 1e-6) and of
     |v| <= 1e5 (printed), the exact ones bitwise torch.sin's and
     torch.cos's over both; then phase 10's checks with the switch at 0 at
     phase 10's three shapes, fp32 and bf16, K7 with and without dx, with
     phase 10's gates and bitwise repeats: the four exact instantiations
     against their plain versions on torch.sin/torch.cos; and the exact
     kernels' outputs differ from the polynomial ones on the same inputs;
  29. this script with --exact-sine-path in a child process under
     MSRA_TPU_FAST_SIN=0: train_pigan on test.json's stage 0 in mode 1 and
     mode 2 (8 iterations each, the last 4 timed), K8 4 times and K7 once
     per iteration, every launch an exact-sine one, finite losses; then
     train_img (siren, batch 65,536) for 10 + 100 steps on torch.sin, no
     kernel launched;
  30. K8 in fp32 and bf16 and K7 with the exact sine per launch at both
     shapes beside their plain versions and a bound that counts the exact
     sine's SASS instructions (the polynomial rows' times are phase 15's).
The repo-level tools, use_fused_mlp=False and pi-GAN's plain trunk (each
phase's seconds printed; the tools at cut schedules, their defaults run by
hand):
  31. train_nerf.train on the lego recipe with use_fused_mlp=False, 30
     iterations: the plain models (fp32 cuBLAS) in the step, no kernel of
     the port launched but the fused fp32 forward of the closing preview
     render (once per pass), the loss falling; ms/step over the last 20
     beside phase 3's;
  32. tools/torch_ablation_nerf.py 300 64 (cut from 2000) in a temporary
     run root: each of its 4 runs through K1/K2, K2's delta chain and its
     split-K pass twice per step (counted around each train_nerf.train
     call), the fused fp32 forward once per pass of every render (the
     runs' previews and the held-out views), a test.json per run with the
     JAX test_nerf's keys, the
     analysis plots where matplotlib is installed (else their skip notes)
     and demo_param.jpg;
  33. tools/torch_soak_nerf.py 1000 100 10 --i-save 100 (cut from 200000
     400 50) in a child process: its trainer CLI killed past the
     checkpoint at 25% and resumed under tools/supervise.py (rc 0, from a
     checkpoint at or past the kill step, phase A's checkpoints untouched),
     log.npy over every iteration, the eval sweep's test.json; the PSNR
     and the eval render's seconds per view printed (the 28 dB gate holds
     only at the full schedule);
  34. tools/torch_profile_pigan.py at both stages of test.json (64 at
     32x32, 16 at 64x64), 5 timed calls a row: every row finite, the rows
     that run G with K8 in fp32 twice per call and K7 once per backward,
     the five largest device kernels of D's rows;
  35. tools/torch_film_modes.py: G fwd and fwd+bwd in mode 0 at stage 0
     and in modes 0 (no launch), 1 (K8 fp32 2 per call, K7 1 per backward)
     and 2 (K8 bf16, K7) at stage 1, every row finite, mode 0's fwd+bwd
     peak memory printed and at most 48 GiB at each stage (the plain trunk
     under autograd), the caller's MSRA_TPU_FUSED_FILM restored;
  36. tools/torch_soak_siren.py's image (300 steps) and SDF (300 steps,
     killed past the checkpoint at 25% and resumed, the final mesh at n
     128) soaks: both trainer CLIs exit 0, both logs span every step, no
     launch in this process, and the SIREN trainers load no kernel module
     of the port (so their CLIs cannot launch one);
  37. tools/torch_pigan_ckpt_grids.py on phase 18's gate experiment: one
     row per checkpoint, K8 in fp32 only, 2 launches per checkpoint;
  38. train_pigan.train on test.json in mode 0 (MSRA_TPU_FUSED_FILM=0, the
     plain trunk) over both stages, iterations [3, 6] with fade-in [0, 2]:
     no kernel of the port launched (the demo grid included), every loss
     finite, the checkpoint and the demo grid of iteration 6 written, ms
     per iteration at stage 1 and the peak memory printed.
The split-K pass's launches are counted over every path: 2 per NeRF step
(K2's), 1 per K5 chunk, 1 per K7 chunk; the delta chain's: 2 per NeRF step
(K2's), 1 per bf16 K5 chunk.
The second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
(`--exact-sine-path` runs phase 29's child alone, under the caller's
MSRA_TPU_FAST_SIN.)
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16 and tf32
# FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 494.7e12
COARSE_N, FINE_N = 1024 * 64, 1024 * 192
ROOFLINE_BATCH = 1024   # rays; the roofline tool's MLP points: 262,144
ROOT = os.path.dirname(os.path.abspath(__file__))


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0]


def phase(name):
    print(f"[phase] {name}", flush=True)


def seeded_inputs(torch, K, n, seed=0):
    """Points on lego-like rays (radius-4 orbit, near 2, far 6), the packed
    weights of a NeRF with random weights and small random biases, and an
    output gradient."""
    from msra_practice_project_tpu_torch.models.nerf import nerf_model

    g = torch.Generator().manual_seed(seed)
    model = nerf_model(generator=g)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.uniform_(-0.1, 0.1, generator=g)
    rays = n // 64
    ro = torch.randn(rays, 3, generator=g) * 0.1 + torch.tensor([0, 0, 4.0])
    rd = -ro / ro.norm(dim=-1, keepdim=True) + 0.1 * torch.randn(
        rays, 3, generator=g)
    z = torch.linspace(2.0, 6.0, 64)
    pts = ro[:, None] + rd[:, None] * z[None, :, None]
    dirs = (rd / rd.norm(dim=-1, keepdim=True))[:, None].expand(pts.shape)
    x = torch.cat([pts, dirs], -1).reshape(-1, 6)
    packed = K.pack_nerf_params(model)
    w = [packed[k].detach() for k in K.PACK_KEYS]
    dy = torch.randn(n, K.OUT_PAD, generator=g) * 1e-3
    dy[:, 4:] = 0
    return K.pad_points(x), w, dy


def rel_frob(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check_kernels(torch, K, n):
    """Kernel vs plain version on the card, same inputs.  Returns the bf16
    mode's max |kernel - plain| per kernel."""
    x, w, dy = seeded_inputs(torch, K, n)
    x, dy = x.cuda(), dy.cuda()
    report = {}
    for bf16 in (False, True):
        wk = [t.cuda() for t in K.kernel_weights(w, bf16)]
        out_k, acts_k = K.nerf_mlp_fwd_save(x, wk, bf16)
        out_p, acts_p = K.nerf_mlp_fwd_save_plain(x, wk, bf16)
        torch.cuda.synchronize()
        out_err = float((out_k - out_p).abs().max())
        acts_err = float((acts_k.float() - acts_p.float()).abs().max())
        if bf16:
            # Two bf16 implementations that sum in different orders store
            # some activations one bf16 ulp apart, and the flips propagate:
            # with sigma up to ~4, a few outputs move by about one bf16 ulp
            # at that magnitude (2^-6..2^-5), far beyond 5e-3, while the
            # relative Frobenius error stays ~1e-4.  So the check is in the
            # norm, with a max-abs bound of a few ulps.
            ok = (rel_frob(out_k, out_p) <= 1e-3 and out_err <= 5e-2
                  and rel_frob(acts_k.float(), acts_p.float()) <= 5e-2)
        else:
            ok = (out_err <= 1e-4 * float(out_p.abs().max())
                  and acts_err <= 1e-4 * float(acts_p.abs().max()))
        print(f"  K1 bf16={bf16}: out max|err| {out_err:.3e} (rgb "
              f"{float((out_k - out_p)[:, :3].abs().max()):.3e}, max|sigma| "
              f"{float(out_p[:, 3].abs().max()):.3e}), out rel "
              f"{rel_frob(out_k, out_p):.3e}, acts max|err| "
              f"{acts_err:.3e}, acts rel "
              f"{rel_frob(acts_k.float(), acts_p.float()):.3e} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit("K1 disagrees with its plain version")
        # K2 from the same saved activations
        g_k = K.nerf_mlp_bwd_saved(wk, dy, acts_k, bf16)[0]
        g_k2 = K.nerf_mlp_bwd_saved(wk, dy, acts_k, bf16)[0]
        g_p = K.nerf_mlp_bwd_saved_plain(wk, dy, acts_k, bf16)[0]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
        worst, key, max_abs = grad_worst(K, g_k, g_p, bf16)
        ok = same and worst <= (5e-2 if bf16 else 1e-4)
        print(f"  K2 bf16={bf16}: worst {'rel frob' if bf16 else 'err/max'} "
              f"{worst:.3e} at {key}, max|err| {max_abs:.3e}, bitwise repeat "
              f"{same} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit("K2 disagrees with its plain version or is not "
                             "reproducible")
        d_err = check_deltas(torch, K, wk, dy, acts_k, bf16)
        if bf16:
            report = {"nerf_mlp_fwd_save": out_err,
                      "nerf_mlp_bwd_saved": max_abs,
                      "nerf_mlp_deltas": d_err}
        del acts_k, acts_p, g_k, g_k2, g_p
        torch.cuda.synchronize()
    return report


def check_deltas(torch, K, wk, dy, acts, bf16):
    """K2's delta chain alone against its plain version on the same saved
    activations, per delta slot: fp32 max|err| <= 1e-4 of max|ref|, bf16
    relative Frobenius <= 5e-2 (K2's gates); bitwise repeat, and bitwise
    equal to the deltas K2's own launch returns (dh9, dh5, dh0).  Returns
    max |kernel - plain|."""
    d_k = K.nerf_mlp_deltas(wk, dy, acts, bf16)
    d_k2 = K.nerf_mlp_deltas(wk, dy, acts, bf16)
    dh2 = K.nerf_mlp_bwd_saved(wk, dy, acts, bf16)[1]
    d_p = K.nerf_mlp_deltas_plain(wk, dy, acts, bf16).float()
    torch.cuda.synchronize()
    worst, key = -1.0, None
    for name, (o0, o1) in K.DELTA_OFFS.items():
        a, b = d_k[:, o0:o1].float(), d_p[:, o0:o1]
        err = float((a - b).abs().max())
        r = (rel_frob(a, b) if bf16 and float(b.norm()) > 0
             else err / max(float(b.abs().max()), 1e-30))
        if r > worst:
            worst, key = r, name
    max_abs = float((d_k.float() - d_p).abs().max())
    same = torch.equal(d_k, d_k2) and all(
        torch.equal(t, d_k[:, K.DELTA_OFFS[n][0]:K.DELTA_OFFS[n][1]])
        for t, n in zip(dh2, ("dh9", "dh5", "dh0")))
    ok = same and worst <= (5e-2 if bf16 else 1e-4)
    print(f"  K2's delta chain alone bf16={bf16}: worst "
          f"{'rel frob' if bf16 else 'err/max'} {worst:.3e} at {key}, "
          f"max|err| {max_abs:.3e}, bitwise repeat and == K2's deltas {same} "
          f"-> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("K2's delta chain disagrees with its plain version, "
                         "is not reproducible or differs from K2's")
    del d_k, d_k2, d_p, dh2
    return max_abs


def check_fwd(torch, K, n):
    """K3 and K6 against their plain version on the card, same inputs, with
    K1's output gates; K3 must be bitwise equal to K1's output and K6 to K3.
    Returns the bf16 mode's max |kernel - plain| per kernel."""
    x, w, _ = seeded_inputs(torch, K, n)
    x = x.cuda()
    report = {}
    for bf16 in (False, True):
        wk = [t.cuda() for t in K.kernel_weights(w, bf16)]
        k1 = K.nerf_mlp_fwd_save(x, wk, bf16)[0]
        k3 = K.nerf_mlp_fwd(x, wk, bf16)
        k6 = K.nerf_mlp_fwd_pipelined(x, wk, bf16)
        ref = K.nerf_mlp_fwd_plain(x, wk, bf16)
        torch.cuda.synchronize()
        k3_k1, k6_k3 = torch.equal(k3, k1), torch.equal(k6, k3)
        ok, errs, line = k3_k1 and k6_k3, {}, []
        for name, out in (("nerf_mlp_fwd", k3),
                          ("nerf_mlp_fwd_pipelined", k6)):
            err = float((out - ref).abs().max())
            errs[name] = err
            if bf16:
                ok = ok and rel_frob(out, ref) <= 1e-3 and err <= 5e-2
            else:
                ok = ok and err <= 1e-4 * float(ref.abs().max())
            line.append(f"{'K3' if name == 'nerf_mlp_fwd' else 'K6'} max|err| "
                        f"{err:.3e} rel {rel_frob(out, ref):.3e}")
        print(f"  K3/K6 bf16={bf16}: {', '.join(line)} (max|ref| "
              f"{float(ref.abs().max()):.3e}); K3 == K1 out {k3_k1}, "
              f"K6 == K3 {k6_k3} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit("K3/K6 disagree with their plain version, with "
                             "K1 or with each other")
        if bf16:
            report = errs
        del k1, k3, k6, ref
    return report


def view_field(torch, n, seed=0):
    """A PE NeRF on the card with the source's init and its density bias
    drawn from [1, 2] (as the benchmark's view cell draws it), and n points
    on lego-like rays (radius-4 orbit, near 2, far 6, 64 a ray)."""
    from msra_practice_project_tpu_torch.models.nerf import nerf_model

    g = torch.Generator().manual_seed(seed)
    model = nerf_model(generator=g)
    with torch.no_grad():
        model.sigma.bias.uniform_(1.0, 2.0, generator=g)
    rays = n // 64
    ro = torch.randn(rays, 3, generator=g) * 0.1 + torch.tensor([0, 0, 4.0])
    rd = -ro / ro.norm(dim=-1, keepdim=True) + 0.1 * torch.randn(
        rays, 3, generator=g)
    z = 2.0 + 4.0 * torch.rand(rays, 64, generator=g).sort(-1)[0]
    pts = ro[:, None] + rd[:, None] * z[..., None]
    dirs = (rd / rd.norm(dim=-1, keepdim=True))[:, None].expand(pts.shape)
    x = torch.cat([pts, dirs], -1).reshape(-1, 6)
    return model.cuda().requires_grad_(False), x.cuda()


def check_nerf_tf32(torch, K, build):
    """The fused fp32 forward (nerf_fwd_tf32_kernel): ptxas (-v) must report
    no spills; at a view tile's two passes (VIEW_TILE_N points) against its
    plain version (3xTF32 emulated) and the plain model's fp32 forward, each
    within 1e-4 of max|ref|, two launches bitwise equal, the model's own
    forward the kernel's output; per launch (CUDA events, median)
    beside its 3xTF32 bound, its plain version and the plain model's
    forward on cuBLAS.  Then a 200x200 render_image of two PE models
    without autograd: the kernel twice per tile of 16,384 rays, and the
    view's rgb within 1e-4 of the plain models' view (the mean of the
    smallest 99% of its gaps, as the benchmark's view cell reads it)."""
    from msra_practice_project_tpu_torch.models.nerf import nerf_model
    from msra_practice_project_tpu_torch.ops.render import render_image

    use = [v for k, v in build.ptxas_usage("nerf_mlp").items()
           if NERF_TF32_KERNEL in k]
    print(f"  ptxas: {NERF_TF32_KERNEL} {use}", flush=True)
    if len(use) != 1 or use[0].get("spill_stores", 1) or use[0].get(
            "spill_loads", 1):
        raise SystemExit(f"{NERF_TF32_KERNEL} spills or is missing")
    res = {"ptxas": use[0]}
    for n in VIEW_TILE_N:
        model, x = view_field(torch, n, seed=n)
        packed = K.pack_nerf_params(model)
        w = K.kernel_weights([packed[k] for k in K.PACK_KEYS], False)
        xp = K.pad_points(x)
        out = K.nerf_mlp_fwd_tf32(xp, w)
        again = K.nerf_mlp_fwd_tf32(xp, w)
        emul = K.nerf_mlp_fwd_tf32_plain(xp, w)
        with torch.no_grad():
            plain = model.forward_plain(x)
            routed = model(x)
        torch.cuda.synchronize()
        scale = float(plain.abs().max())
        r = {"err_vs_plain_version": float((out - emul).abs().max()) / scale,
             "err_vs_fp32_forward": float((out[:n, :4] - plain).abs().max())
             / scale,
             "bitwise_repeat": torch.equal(out, again),
             "route_is_kernel": torch.equal(routed, out[:n, :4]),
             "pad_zero": bool((out[:, 4:] == 0).all())}
        del emul, again
        r.update(
            ms=time_ms(torch, lambda: K.nerf_mlp_fwd_tf32(xp, w), 10),
            plain_ms=time_ms(torch, lambda: K.nerf_mlp_fwd_tf32_plain(xp, w),
                             3),
            library_ms=time_ms(torch, lambda: model.forward_plain(x), 5),
            bound_ms=3 * 2 * K.macs_per_point()["fwd"] * n
            / VIEW_FLOP_PER_S * 1e3)
        ok = (r["err_vs_plain_version"] <= 1e-4
              and r["err_vs_fp32_forward"] <= 1e-4 and r["bitwise_repeat"]
              and r["route_is_kernel"] and r["pad_zero"])
        print(f"  N={n}: {r} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit("the fused fp32 NeRF forward disagrees with its "
                             "plain version or is not reproducible")
        res[n] = r
        del model, x, xp, out, plain, routed

    side, chunk = 200, 16384
    g = torch.Generator().manual_seed(1)
    coarse, fine = (nerf_model(generator=g) for _ in range(2))
    with torch.no_grad():
        for m in (coarse, fine):
            m.sigma.bias.uniform_(1.0, 2.0, generator=g)
    coarse, fine = coarse.cuda(), fine.cuda()
    pose = torch.tensor([[1, 0, 0, 0], [0, 0.5, -0.866, -3.46],
                         [0, 0.866, 0.5, 2.0], [0, 0, 0, 1.0]])

    def view(cf, ff):
        return render_image(side, side, 277.78, pose, 2.0, 6.0, cf, ff, 64,
                            128, chunk=chunk, device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(2))[0]

    before = K.nerf_mlp_fwd_tf32.launches
    got = view(coarse, fine)
    launches = K.nerf_mlp_fwd_tf32.launches - before
    want = view(coarse.forward_plain, fine.forward_plain)
    gaps = (got - want).abs().reshape(-1).sort()[0]
    gap = float(gaps[:int(0.99 * gaps.numel())].mean())
    tiles = -(-side * side // chunk)
    ok = launches == 2 * tiles and gap <= 1e-4
    print(f"  render_image {side}x{side}, {tiles} tiles: {launches} launches "
          f"(2 per tile), rgb gap to the plain models' view {gap:.3e} "
          f"(widest {float(gaps[-1]):.3e}) -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit("render_image's PE models did not take the fused "
                         "fp32 forward twice per tile, or its view is off")
    res["render"] = {"tiles": tiles, "launches": launches, "rgb_gap": gap}
    return res


def grad_worst(K, got, ref, bf16):
    """(worst per-tensor error: relative Frobenius in bf16, max|err| / max|ref|
    in fp32; the tensor; max |err|) over the packed gradients."""
    worst, key, max_abs = -1.0, None, 0.0
    for k, a, b in zip(K.PACK_KEYS, got, ref):
        err = float((a - b).abs().max())
        max_abs = max(max_abs, err)
        if bf16:
            r = rel_frob(a, b) if float(b.norm()) > 0 else err
        else:
            r = err / max(float(b.abs().max()), 1e-30)
        if r > worst:
            worst, key = r, k
    return worst, key, max_abs


def check_bwd(torch, K, n):
    """K5 and K4 against their plain versions on the card, in fp32 and bf16.

    On the same inputs: K5's dW/db against the plain delta chain on the
    activations K5 recomputes (K1's, bitwise: checked below) with K2's gates
    (fp32 1e-4 of max|ref|, bf16 5e-2 relative Frobenius per tensor), and K4
    against its plain version on K5's copy of the deltas and on K2's delta
    workspace with K7's dx gates (fp32 1e-3 of max|ref|, bf16 5e-2
    relative Frobenius).  End to end, against the
    plain K5 (its own recompute) and plain K4: relative Frobenius per
    tensor, 5e-3 in fp32 (a relu mask that flips between two fp32 forwards
    moves one point's deltas; bf16 arithmetic reads ~1e-2) and 5e-2 in
    bf16.  Bitwise: K5's dW/db = K1 -> K2's,
    dx from K5 + K4 = dx from K2 + K4, two K5 launches, two K4 launches,
    need_dx=False's dW/db = need_dx=True's.  Returns the bf16 mode's max
    |kernel - plain| per kernel (on the same inputs)."""
    x, w, dy = seeded_inputs(torch, K, n)
    x, dy = x.cuda(), dy.cuda()
    report = {}

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    for bf16 in (False, True):
        wk = [t.cuda() for t in K.kernel_weights(w, bf16)]
        _, acts = K.nerf_mlp_fwd_save(x, wk, bf16)
        g2, dh2 = K.nerf_mlp_bwd_saved(wk, dy, acts, bf16)
        dx2 = K.nerf_mlp_dx(x, wk, dh2, bf16)
        dx2_k4 = K.nerf_mlp_dx_plain(x, wk, dh2, bf16)
        g_chain = K.nerf_mlp_bwd_saved_plain(wk, dy, acts, bf16)[0]
        del acts
        g5, dh5 = K.nerf_mlp_bwd(x, wk, dy, bf16, True)
        g5b, dh5b = K.nerf_mlp_bwd(x, wk, dy, bf16, True)
        g5n, dh5n = K.nerf_mlp_bwd(x, wk, dy, bf16, False)
        dx5 = K.nerf_mlp_dx(x, wk, dh5, bf16)
        dx5b = K.nerf_mlp_dx(x, wk, dh5, bf16)
        g_p, dh_p = K.nerf_mlp_bwd_plain(x, wk, dy, bf16, True)
        dx_k4 = K.nerf_mlp_dx_plain(x, wk, dh5, bf16)
        dx_p = K.nerf_mlp_dx_plain(x, wk, dh_p, bf16)
        torch.cuda.synchronize()
        bits = {"K5 == K1->K2": same(g5, g2),
                "dx K5+K4 == K2+K4": torch.equal(dx5, dx2),
                "K5 repeat": same(g5, g5b) and same(dh5, dh5b),
                "K4 repeat": torch.equal(dx5, dx5b),
                "need_dx=False == True": dh5n is None and same(g5n, g5)}
        worst, key, max_abs = grad_worst(K, g5, g_chain, bf16)
        e2e, e2e_key, _ = grad_worst(K, g5, g_p, True)
        k4s, k4_err = [], 0.0
        for got, ref in ((dx5, dx_k4), (dx2, dx2_k4)):  # K5's copy, K2's
            err = float((got - ref).abs().max())
            k4_err = max(k4_err, err)
            k4s.append(rel_frob(got, ref) if bf16
                       else err / max(float(ref.abs().max()), 1e-30))
        dx_e2e = rel_frob(dx5, dx_p)
        e2e_gate = 5e-2 if bf16 else 5e-3
        ok = (all(bits.values()) and worst <= (5e-2 if bf16 else 1e-4)
              and max(k4s) <= (5e-2 if bf16 else 1e-3) and e2e <= e2e_gate
              and dx_e2e <= e2e_gate)
        print(f"  K5/K4 bf16={bf16}: K5 vs plain chain on its activations "
              f"{'rel frob' if bf16 else 'err/max'} {worst:.3e} at {key} "
              f"(max|err| {max_abs:.3e}); K4 vs plain on K5's copy / K2's "
              f"workspace {'rel frob' if bf16 else 'err/max'} {k4s[0]:.3e} "
              f"/ {k4s[1]:.3e} (max|err| "
              f"{k4_err:.3e}); end to end vs plain K5 + K4: dW/db rel frob "
              f"{e2e:.3e} at {e2e_key}, dx rel frob {dx_e2e:.3e} (max|err| "
              f"{float((dx5 - dx_p).abs().max()):.3e}, max|ref| "
              f"{float(dx_p.abs().max()):.3e}); {bits} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit("K5/K4 disagree with their plain versions or "
                             "break a bitwise equality")
        if bf16:
            report = {"nerf_mlp_bwd": max_abs, "nerf_mlp_dx": k4_err}
        del g2, dh2, dx2, dx2_k4, g_chain, g5, dh5, g5b, dh5b, g5n, dx5
        del dx5b, g_p, dh_p, dx_k4, dx_p
        torch.cuda.synchronize()
    return report


# pi-GAN at test.json's stage 0: 64 images of 32x32 rays, 8 coarse and
# 8 + 16 fine samples per ray
FILM_B, FILM_COARSE_P, FILM_FINE_P = 64, 32 * 32 * 8, 32 * 32 * 24
FILM_SLICE = 16   # images per slice of the plain versions on the card
FILM_ROWS = FILM_B * FILM_COARSE_P   # K7's rows at the coarse shape
# 5 tiles per image: 15 per chunk, so the last CTA of the bf16 pass has one
# idle warpgroup and CTA 2 holds tiles of images 0 and 1
FILM_ODD = (3, 320)
# K7's and K8's bf16 per-tile kernels (csrc/film_mlp.cu)
TC_KERNELS = ("film_bwd_delta_tc_kernel", "film_fwd_tc_kernel")
# K8's fp32 kernel: 3xTF32 on wgmma
TF32_KERNEL = "film_fwd_tf32_kernel"
# K7's fp32 check mode (CUDA cores)
F32_DELTA_KERNEL = "film_bwd_delta_kernel"
# Every FiLM kernel that takes the trunk sine has a polynomial and an exact
# instantiation (template argument EXACT); a mangled name with a true bool
# template argument is the exact one, reported as "<kernel><exact>".
EXACT_TAG, EXACT = "Lb1E", "<exact>"
# K1's (K3's, K6's), K2's delta chain's and K4's (csrc/nerf_mlp.cu)
NERF_TC_KERNELS = ("nerf_fwd_tc_kernel", "nerf_bwd_delta_tc_kernel",
                   "dx_tc_kernel")
# the NeRF MLP's fused fp32 forward (3xTF32 on wgmma), and a 400x400 view's
# tile of 16,384 rays: its coarse and fine passes' points
NERF_TF32_KERNEL = "nerf_fwd_tf32_kernel"
VIEW_TILE_N = (16384 * 64, 16384 * 192)
VIEW_FLOP_PER_S = 494.7e12   # dense TF32, the fp32 bound's rate


def film_inputs(torch, FK, n_img, n_pts, seed=0, res=32):
    """The G step's trunk inputs at stage 0: points on rays of random poses
    from the pose prior (radius 1, near 0.5, far 1.5, res x res pixels
    (32: test.json's stage 0; 64: synthesis), fov 12), film from the
    mapping network of random latents, a generator with random weights,
    and an output gradient."""
    from msra_practice_project_tpu_torch.models import pigan

    g = torch.Generator().manual_seed(seed)
    gen = pigan.Generator(pigan.GeneratorConfig(), generator=g)
    z = torch.randn(n_img, gen.cfg.z_dim, generator=g)
    theta, phi = gen.sample_poses(n_img, g)
    with torch.no_grad():
        film = gen.mapping(z)
    n_s = -(-n_pts // (res * res))   # the rays' first n_pts points
    focal = res / 2.0 / torch.tan(torch.tensor(6.0 * 3.141592653589793 / 180))
    from msra_practice_project_tpu_torch.ops.rays import get_rays_flat
    ro, rd = get_rays_flat(res, res, focal, pigan.camera_poses(theta, phi))
    zv = 0.5 + torch.rand(n_img, res * res, n_s, generator=g).sort(-1)[0]
    pts = ro[..., None, :] + rd[..., None, :] * zv[..., None]
    dirs = (rd / rd.norm(dim=-1, keepdim=True))[..., None, :].expand(
        pts.shape)
    x = torch.cat([pts, dirs], -1).reshape(n_img, -1, 6)[:, :n_pts]
    packed = FK.pack_film_params(dict(gen.trunk.named_parameters()), True)
    w = [packed[k].detach() for k in FK.PACK_KEYS]
    dy = torch.randn(n_img, n_pts, FK.OUT_PAD, generator=g) * 1e-3
    dy[..., 4:] = 0
    return FK.pad_points(x, n_img)[0], film.contiguous(), w, dy


def film_plain_sliced(torch, FK, x, film, dy, wk, bf16, need_dx):
    """The plain K8 and K7 over slices of FILM_SLICE images (the whole
    batch's activations would not fit on the card): out, dx, dfilm
    concatenated, the packed gradients summed in fp32."""
    outs, dxs, dfilms, grads = [], [], [], None
    for lo in range(0, x.shape[0], FILM_SLICE):
        sl = slice(lo, lo + FILM_SLICE)
        outs.append(FK.film_mlp_fwd_plain(x[sl], film[sl], wk, bf16))
        dx, dfilm, g = FK.film_mlp_bwd_plain(x[sl], film[sl], dy[sl], wk,
                                             bf16, need_dx)
        dxs.append(dx)
        dfilms.append(dfilm)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    return (torch.cat(outs), torch.cat(dxs) if need_dx else None,
            torch.cat(dfilms), grads)


def relu_flips_explain_bs(out_k, out_p, dy, bs_k):
    """K7's sigma-bias gradient is the sum of dy's sigma lane over the
    points whose sigma is positive.  Where the kernel's relu mask and the
    plain version's differ (a sigma near zero flipped by the 1-ulp bf16
    differences that propagate through the trunk), the two sums differ by
    those points' dy, and in one image's sum of zero-mean terms that can
    exceed the relative gate.  True when the kernel's bs is the exact sum
    over its own mask (K8's output; 1e-5 of the sum of |terms|) and every
    flipped point's sigma is under 1e-2 of max sigma; prints the flips."""
    sk, sp = out_k[..., 3], out_p[..., 3]
    mask = (sk > 0).float()
    flips = (sk > 0) != (sp > 0)
    d = dy[..., 3]
    own, scale = float((d * mask).sum()), float((d.abs() * mask).sum())
    near = float(sk.maximum(sp)[flips].max()) if bool(flips.any()) else 0.0
    err = abs(float(bs_k.reshape(-1)[0]) - own)
    ok = err <= 1e-5 * scale and near <= 1e-2 * float(sp.abs().max())
    print(f"      bs: {int(flips.sum())} relu flips (max |sigma| there "
          f"{near:.3e}, max sigma {float(sp.abs().max()):.3e}); kernel bs vs "
          f"the sum over its own mask {err:.3e} (gate {1e-5 * scale:.3e}) -> "
          f"{'explained' if ok else 'NOT explained'}", flush=True)
    return ok


def check_film(torch, FK, n_img, n_pts, side=32):
    """K8 and K7 against their plain versions on the card, same inputs, in
    fp32 and bf16, K7 with need_dx False and True; two K7 launches and two
    K8 launches must be bitwise equal; K7's sigma bias (bs) outside its
    gate passes only when relu flips explain it exactly
    (relu_flips_explain_bs).  Returns the max |kernel - plain|
    per kernel, K8's fp32 mode as film_mlp_fwd_f32, and K7's dfilm error
    (err/max in fp32, relative Frobenius in bf16) as dfilm_f32 and
    dfilm_bf16."""
    x, film, w, dy = film_inputs(torch, FK, n_img, n_pts, res=side)
    x, film, dy = x.cuda(), film.cuda(), dy.cuda()
    report = {}
    for bf16 in (False, True):
        wk = [t.cuda() for t in FK.kernel_weights(w, bf16)]
        out_k = FK.film_mlp_fwd(x, film, wk, bf16)
        fwd_same = torch.equal(out_k, FK.film_mlp_fwd(x, film, wk, bf16))
        runs = {nd: [FK.film_mlp_bwd(x, film, dy, wk, bf16, nd)
                     for _ in range(2)] for nd in (False, True)}
        out_p, dx_p, dfilm_p, g_p = film_plain_sliced(torch, FK, x, film, dy,
                                                      wk, bf16, True)
        torch.cuda.synchronize()
        res = {"out": (out_k, out_p), "dx": (runs[True][0][0], dx_p),
               "dfilm": (runs[True][0][1], dfilm_p),
               **{k: (a, b) for k, a, b in zip(FK.PACK_KEYS,
                                               runs[True][0][2], g_p)}}
        same = all(
            torch.equal(a, b) for nd in (False, True)
            for a, b in zip([runs[nd][0][1], *runs[nd][0][2]],
                            [runs[nd][1][1], *runs[nd][1][2]]))
        nodx_same = (runs[False][0][0] is None and torch.equal(
            runs[False][0][1], runs[True][0][1]) and all(
                torch.equal(a, b) for a, b in zip(runs[False][0][2],
                                                  runs[True][0][2])))
        worst, worst_key, max_abs = {}, {}, {"fwd": 0.0, "bwd": 0.0}
        for key, (a, b) in res.items():
            kern = "fwd" if key == "out" else "bwd"
            err = float((a - b).abs().max())
            max_abs[kern] = max(max_abs[kern], err)
            r = (rel_frob(a, b) if bf16 else
                 err / max(float(b.abs().max()), 1e-30))
            if key == "dfilm":
                report[f"dfilm_{'bf16' if bf16 else 'f32'}"] = r
            print(f"    bf16={bf16} {key:5s} max|err| {err:.3e} "
                  f"{'rel frob' if bf16 else 'err/max'} {r:.3e} max|ref| "
                  f"{float(b.abs().max()):.3e}", flush=True)
            if (key == "bs" and r > FILM_GATES[bf16]["bwd"]
                    and relu_flips_explain_bs(out_k, out_p, dy, a)):
                continue
            if r >= worst.get(kern, -1.0):
                worst[kern], worst_key[kern] = r, key
        gate = FILM_GATES[bf16]
        ok = (worst["fwd"] <= gate["fwd"] and worst["bwd"] <= gate["bwd"]
              and same and nodx_same and fwd_same)
        print(f"  bf16={bf16}: K8 worst {worst['fwd']:.3e} (gate "
              f"{gate['fwd']:g}), bitwise repeat {fwd_same}; K7 worst "
              f"{worst['bwd']:.3e} at {worst_key['bwd']} (gate "
              f"{gate['bwd']:g}); bitwise repeat {same}; need_dx=False same "
              f"grads {nodx_same} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit("K7/K8 disagree with their plain versions")
        if bf16:
            report.update(film_mlp_fwd=max_abs["fwd"],
                          film_mlp_bwd=max_abs["bwd"])
        else:
            report["film_mlp_fwd_f32"] = max_abs["fwd"]
        del runs, res, out_k, out_p, dx_p, dfilm_p, g_p
        torch.cuda.synchronize()
    return report


# test.json's stages: (batch, resolution)
PIGAN_STAGES = ((64, 32), (16, 64))


def check_mode1_trunk(torch, FK, batch, resolution):
    """Mode 1's trunk (the default on CUDA tensors: K8 in fp32) on the
    points the generator's render_film feeds it, a coarse and a fine call
    for `batch` images of resolution^2 pixels with test.json's 8 + 16
    samples (random weights and latents), against the plain trunk
    (_apply_plain) on the same inputs: max |err| / max |ref| within K8's
    fp32 gate, and each call one fp32 K8 launch.  MSRA_TPU_FUSED_FILM is
    unset for the check.  Returns the worst ratio."""
    old = os.environ.pop("MSRA_TPU_FUSED_FILM", None)
    try:
        return _check_mode1_trunk(torch, FK, batch, resolution)
    finally:
        if old is not None:
            os.environ["MSRA_TPU_FUSED_FILM"] = old


def _check_mode1_trunk(torch, FK, batch, resolution):
    from msra_practice_project_tpu_torch.models import pigan

    g = torch.Generator().manual_seed(2)
    gen = pigan.Generator(pigan.GeneratorConfig(
        resolution=resolution, coarse_samples=8, fine_samples=16),
        generator=g).cuda()
    trunk, calls = gen.trunk, []

    def record(x, film, need_dx=True):
        calls.append((x.detach().clone(), film.detach().clone()))
        return pigan.FilmSirenNeRF.forward(trunk, x, film, need_dx)

    trunk.forward = record
    z = torch.randn(batch, gen.cfg.z_dim, generator=g).cuda()
    with torch.no_grad():
        gen(z, generator=torch.Generator(device="cuda").manual_seed(3))
    del trunk.forward
    worst = 0.0
    for x, film in calls:
        before = FK.film_mlp_fwd.launches_f32
        with torch.no_grad():
            got = trunk(x, film, need_dx=False)
            ref = trunk._apply_plain(x, film)
        torch.cuda.synchronize()
        r = float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                 1e-30)
        worst = max(worst, r)
        k8 = FK.film_mlp_fwd.launches_f32 - before
        print(f"  trunk call on x {tuple(x.shape)}: err/max {r:.3e} (gate "
              f"{FILM_GATES[False]['fwd']:g}), fp32 K8 launches {k8}",
              flush=True)
        if not (r <= FILM_GATES[False]["fwd"] and k8 == 1
                and got.shape == ref.shape):
            raise SystemExit("mode 1's trunk disagrees with the plain trunk")
        del got, ref
    if len(calls) != 2:
        raise SystemExit(f"render_film called the trunk {len(calls)} times")
    return worst


# Gates of the K7/K8 checks (PERF.md §2): fp32 max |err| over max |ref| per
# tensor; bf16 relative Frobenius norm per tensor.
FILM_GATES = {False: {"fwd": 1e-4, "bwd": 1e-3},
              True: {"fwd": 2e-2, "bwd": 5e-2}}


def dw_operands(torch, table, n, seed=0):
    """(tasks, acts, deltas, splits) for the split-K pass over n points of
    K2's ("nerf") or K7's ("film") task table: bf16 operands from a seeded
    normal generator on the card, the wrappers' split counts."""
    from msra_practice_project_tpu_torch.ops.kernels import film_mlp as FK
    from msra_practice_project_tpu_torch.ops.kernels import nerf_mlp as K

    mod, act_w = (K, K.ACT_PAD) if table == "nerf" else (FK, FK.ACT_W)
    g = torch.Generator(device="cuda").manual_seed(seed)
    acts = torch.randn(n, act_w, device="cuda", generator=g).bfloat16()
    deltas = torch.randn(n, mod.DELTA_W, device="cuda",
                         generator=g).bfloat16()
    return mod.grad_tasks(), acts, deltas, mod.bwd_splits(n)


DW_SHAPES = (("nerf", COARSE_N), ("nerf", FINE_N), ("film", FILM_ROWS))


def check_dw(torch, DW):
    """The split-K pass against its plain version (module docstring, 1b).
    Returns the largest max |kernel - plain| over the task tables."""
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(64, 64, device="cuda", generator=g).bfloat16()
    d = torch.randn(64, 256, device="cuda", generator=g).bfloat16()
    _, dw = DW.dw_splitk(a, d, [(0, 64, 0, 256, 0)], 1)
    ref = a.float().t() @ d.float()
    torch.cuda.synchronize()
    err = rel_frob(dw.view(64, 256), ref)
    max_abs = float((dw.view(64, 256) - ref).abs().max())
    print(f"  one CTA, 64 x 256 over 64 points vs torch.mm (fp32): rel frob "
          f"{err:.3e}, max|err| {max_abs:.3e} -> "
          f"{'ok' if err <= 5e-2 else 'FAIL'}", flush=True)
    if not err <= 5e-2:
        raise SystemExit("the split-K pass fails on one CTA")
    worst_abs = 0.0
    for table, n in DW_SHAPES:
        tasks, acts, deltas, splits = dw_operands(torch, table, n)
        part, dw = DW.dw_splitk(acts, deltas, tasks, splits)
        part2, dw2 = DW.dw_splitk(acts, deltas, tasks, splits)
        half = splits // 2
        rows = DW.chunks_per_split(n, splits) * DW.PK * half
        part_h, _ = DW.dw_splitk(acts[:rows], deltas[:rows], tasks, half)
        ref_part, ref = DW.dw_splitk_plain(acts, deltas, tasks, splits)
        torch.cuda.synchronize()
        worst, key = -1.0, None
        for t, (_, m, _, nn, off) in enumerate(tasks):
            r = rel_frob(dw[off:off + m * nn], ref[off:off + m * nn])
            if r > worst:
                worst, key = r, t
        max_abs = float((dw - ref).abs().max())
        worst_abs = max(worst_abs, max_abs)
        bits = {"repeat": torch.equal(part, part2) and torch.equal(dw, dw2),
                "first half of the splits alone == whole":
                    torch.equal(part_h, part[:half])}
        ok = worst <= 5e-2 and all(bits.values())
        print(f"  {table} tasks, N={n}, {splits} splits: worst rel frob "
              f"{worst:.3e} (task {key}), max|err| {max_abs:.3e}, partials "
              f"rel frob {rel_frob(part, ref_part):.3e}; {bits} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit("the split-K pass disagrees with its plain "
                             "version or breaks a bitwise equality")
        del acts, deltas, part, part2, part_h, ref_part
        torch.cuda.synchronize()
    return worst_abs


def dw_bound(tasks, n, act_ld, delta_ld):
    """(bound ms, bound_by) of one pass over n points: the act and delta
    columns the tasks use, read once, and dW written once, over HBM's rate,
    against its MACs over the bf16 tensor-core rate."""
    def used(cols):
        return len({c for lo, w in cols for c in range(lo, lo + w)})

    acols = used([(a0, m) for a0, m, _, _, _ in tasks if a0 >= 0])
    dcols = used([(d0, nn) for _, _, d0, nn, _ in tasks])
    assert acols <= act_ld and dcols <= delta_ld
    total = max(off + m * nn for _, m, _, nn, off in tasks)
    macs = sum(m * nn if a0 >= 0 else nn for a0, m, _, nn, _ in tasks)
    t_b = (n * (acols + dcols) * 2 + total * 4) / HBM_BYTES_PER_S * 1e3
    t_o = 2 * macs * n / BF16_FLOP_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def time_dw(torch, DW, table, n, reps):
    """The split-K pass per launch (bf16) beside its plain version, its
    bound and the cuBLAS yardstick (one torch.mm per weight task, one
    column sum per bias task, on the same operands)."""
    tasks, acts, deltas, splits = dw_operands(torch, table, n, seed=1)

    def library():
        for a0, m, d0, nn, _ in tasks:
            d = deltas[:, d0:d0 + nn]
            if a0 < 0:
                d.sum(dim=0)
            else:
                torch.mm(acts[:, a0:a0 + m].t(), d)

    bound, by = dw_bound(tasks, n, acts.shape[1], deltas.shape[1])
    res = {"ms": time_ms(torch, lambda: DW.dw_splitk(acts, deltas, tasks,
                                                     splits), reps),
           "plain_ms": time_ms(torch, lambda: DW.dw_splitk_plain(
               acts, deltas, tasks, splits), 5),
           "library_ms": time_ms(torch, library, reps),
           "bound_ms": bound, "bound_by": by}
    del acts, deltas
    return res


def time_ms(torch, fn, reps):
    """Median of `reps` CUDA-event timings of fn(), after two warm-ups."""
    for _ in range(2):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


# the activation columns K2's delta chain reads: h0..h7 and h9
DELTA_ACT_COLS = 8 * 256 + 128


def bounds(K, n, w):
    """{kernel: {bound_ms, bound_by}}: the least time for one launch's work
    on n points, the larger of its bytes (each input read once, each output
    written once) over HBM's rate and its MACs over the bf16 tensor-core
    rate."""
    wbytes = sum(t.numel() * t.element_size() for t in w)
    pe_wbytes = sum(t.numel() * t.element_size() for k, t in zip(K.PACK_KEYS, w)
                    if k in ("W0", "W5a", "W9b"))
    chain_wbytes = sum(t.numel() * t.element_size()
                       for k, t in zip(K.PACK_KEYS, w)
                       if k in {s[0] for s in K.BWD_SCHEDULE}
                       | {"Ws", "bs", "Wr", "br"})
    macs = K.macs_per_point()
    row, act = K.IN_PAD * 4, K.ACT_PAD * 2    # x, out, dy, dx: 32 B a row
    dh = K.PE_DELTA_W * 2
    grads = K.GRAD_TOTAL * 4
    work = {
        "nerf_mlp_fwd_save": (n * (2 * row + act) + wbytes, macs["fwd"]),
        "nerf_mlp_bwd_saved": (n * (row + act) + wbytes + grads,
                               macs["bwd_saved"]),
        "nerf_mlp_fwd": (n * 2 * row + wbytes, macs["fwd"]),
        "nerf_mlp_fwd_pipelined": (n * 2 * row + wbytes, macs["fwd"]),
        "nerf_mlp_bwd": (n * (2 * row + dh) + wbytes + grads, macs["bwd"]),
        "nerf_mlp_dx": (n * (2 * row + dh) + pe_wbytes, macs["dx"]),
        # reads h0..h7, h9 (masks, heads) and dy; writes every delta
        "nerf_mlp_deltas": (n * (row + DELTA_ACT_COLS * 2 + K.DELTA_W * 2)
                            + chain_wbytes, macs["deltas"]),
    }
    out = {}
    for name, (b, m) in work.items():
        t_b = b / HBM_BYTES_PER_S * 1e3
        t_o = 2 * m * n / BF16_FLOP_PER_S * 1e3
        out[name] = {"bound_ms": max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations"}
    return out


def dx_library_operands(torch, K, w, dh):
    """K4's cuBLAS yardstick operands: K5's delta copy [N, 640] (dh9 | dh5 |
    dh0, as its layout holds them) and the [640, 96] bf16 block matrix of
    the PE weights (W9b^T into columns 64..95 of dh9's rows, W5a^T and W0^T
    into columns 0..63 of dh5's and dh0's), so that one product gives
    [dpe_p | dpe_d]."""
    d = dict(zip(K.PACK_KEYS, w))
    pe = torch.cat(dh, dim=1)
    blocks = torch.zeros(K.PE_DELTA_W, K.PE_POS + K.PE_DIR,
                         dtype=torch.bfloat16, device=pe.device)
    o = K.PE_DELTA_OFFS
    blocks[o["dh9"][0]:o["dh9"][1], K.PE_POS:] = d["W9b"].t()
    blocks[o["dh5"][0]:o["dh5"][1], :K.PE_POS] = d["W5a"].t()
    blocks[o["dh0"][0]:o["dh0"][1], :K.PE_POS] = d["W0"].t()
    return pe, blocks


def time_kernels(torch, K, names, n, reps):
    """{kernel: {ms, plain_ms, bound_ms, bound_by}} for the NeRF kernels in
    `names` (bf16, the path's flags) at n points; K4 (on K5's copy, as the
    path runs it) also on K2's workspace and with its cuBLAS yardstick."""
    x, w, dy = seeded_inputs(torch, K, n, seed=1)
    x, dy = x.cuda(), dy.cuda()
    wk = [t.cuda() for t in K.kernel_weights(w, True)]
    _, acts = K.nerf_mlp_fwd_save(x, wk, True)
    _, dh = K.nerf_mlp_bwd(x, wk, dy, True, True)
    runs = {
        "nerf_mlp_fwd_save": (lambda: K.nerf_mlp_fwd_save(x, wk, True),
                              lambda: K.nerf_mlp_fwd_save_plain(x, wk, True)),
        "nerf_mlp_bwd_saved": (
            lambda: K.nerf_mlp_bwd_saved(wk, dy, acts, True),
            lambda: K.nerf_mlp_bwd_saved_plain(wk, dy, acts, True)),
        "nerf_mlp_deltas": (
            lambda: K.nerf_mlp_deltas(wk, dy, acts, True),
            lambda: K.nerf_mlp_deltas_plain(wk, dy, acts, True)),
        "nerf_mlp_fwd": (lambda: K.nerf_mlp_fwd(x, wk, True),
                         lambda: K.nerf_mlp_fwd_plain(x, wk, True)),
        "nerf_mlp_fwd_pipelined": (
            lambda: K.nerf_mlp_fwd_pipelined(x, wk, True),
            lambda: K.nerf_mlp_fwd_plain(x, wk, True)),
        "nerf_mlp_bwd": (lambda: K.nerf_mlp_bwd(x, wk, dy, True, True),
                         lambda: K.nerf_mlp_bwd_plain(x, wk, dy, True, True)),
        "nerf_mlp_dx": (lambda: K.nerf_mlp_dx(x, wk, dh, True),
                        lambda: K.nerf_mlp_dx_plain(x, wk, dh, True)),
    }
    b = bounds(K, n, wk)
    out = {name: {"ms": time_ms(torch, runs[name][0], reps),
                  "plain_ms": time_ms(torch, runs[name][1], 5), **b[name]}
           for name in names}
    if "nerf_mlp_dx" in names:
        dh2 = K.nerf_mlp_bwd_saved(wk, dy, acts, True)[1]
        pe, blocks = dx_library_operands(torch, K, wk, dh)
        out["nerf_mlp_dx"].update(
            k2_workspace_ms=time_ms(
                torch, lambda: K.nerf_mlp_dx(x, wk, dh2, True), reps),
            library_ms=time_ms(torch, lambda: torch.matmul(pe, blocks), reps))
    return out


def device_kernels(prof):
    """The device kernels of a finished torch.profiler run, as the
    (name, start us, duration us) of its trace's "kernel" events."""
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            return [(e["name"], e["ts"], e["dur"])
                    for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "kernel" and "dur" in e]


def run_train(torch, iterations, startup, timed, window=None,
              config="lego.json", overrides=None):
    """train_nerf.train on the recipe of configs/nerf/<config> (lego's by
    default; the synthetic scene at 400x400) with `overrides`, in a
    temporary directory; its last `timed` steps are one window, timed with
    CUDA events, with `window` entered for them.  Returns (ms/step over the
    window, rays per step, the metric log, checkpoint written, PNG
    written)."""
    from msra_practice_project_tpu_torch.core.config import (
        CONFIG_ROOT, NERF_TRAIN_DEFAULTS, load_config, resolve)
    from msra_practice_project_tpu_torch.train import train_nerf

    cfg = resolve(load_config(os.path.join(CONFIG_ROOT, "nerf", config)),
                  NERF_TRAIN_DEFAULTS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        cfg.update(output_path=out_dir, experiment_name="lego_smoke",
                   iterations=iterations, start_up_itrs=startup, i_print=10,
                   i_save=iterations, i_image=iterations, data_size=400,
                   **(overrides or {}))
        res = train_nerf.train(cfg, timed_steps=timed, window=window)
        torch.cuda.synchronize()
        log = os.path.join(out_dir, "lego_smoke")
        ckpt = os.path.exists(os.path.join(log, f"{iterations:06d}.ckpt"))
        png = os.path.exists(os.path.join(log, f"{iterations:06d}.png"))
    return (res["window_ms"] / timed, cfg["batch_size"], res["log"], ckpt,
            png)


def reset_counts():
    """Every kernel's launch count to 0."""
    from msra_practice_project_tpu_torch.ops.kernels import (dw_splitk,
                                                             film_mlp,
                                                             nerf_mlp)
    for mod in (nerf_mlp, film_mlp, dw_splitk):
        mod.reset_launch_counts()


def dw_launches():
    from msra_practice_project_tpu_torch.ops.kernels import dw_splitk
    return dw_splitk.dw_splitk.launches


class LaunchMeter:
    """A function that calls ``fn`` and adds the K8 (all and fp32) and K7
    launches each call made, and its calls, to ``counts``; with
    ``events``, each call is also timed with CUDA events."""

    KEYS = ("film_mlp_fwd", "film_mlp_fwd_f32", "film_mlp_bwd")

    def __init__(self, FK, fn, events=False):
        self.FK, self.fn = FK, fn
        self.counts = dict.fromkeys(("calls", *self.KEYS), 0)
        self.events = [] if events else None

    def _launches(self):
        FK = self.FK
        return (FK.film_mlp_fwd.launches, FK.film_mlp_fwd.launches_f32,
                FK.film_mlp_bwd.launches)

    def __call__(self, *args, **kwargs):
        import torch
        before = self._launches()
        if self.events is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        out = self.fn(*args, **kwargs)
        if self.events is not None:
            ev[1].record()
            self.events.append(ev)
        self.counts["calls"] += 1
        for k, a, b in zip(self.KEYS, self._launches(), before):
            self.counts[k] += a - b
        return out

    def ms(self, skip=0):
        """Mean ms per call over the calls after the first `skip`."""
        ev = self.events[skip:]
        return sum(a.elapsed_time(b) for a, b in ev) / len(ev)


@contextlib.contextmanager
def replaced(module, name, fn):
    """``module.<name>`` replaced by ``fn`` for the block."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield fn
    finally:
        setattr(module, name, orig)


def metered(FK, module, name, events=False):
    """``module.<name>`` replaced by a LaunchMeter of it for the block."""
    return replaced(module, name,
                    LaunchMeter(FK, getattr(module, name), events))


def nerf_launches(K) -> dict:
    """The NeRF kernels' counters: K1-K6, K2's delta chain, the split-K
    pass."""
    launches = {k.__name__: k.launches for k in K.KERNELS}
    launches["dw_splitk"] = dw_launches()
    launches["nerf_mlp_deltas"] = K.nerf_mlp_deltas.launches
    return launches


def nerf_want(K, steps, renders=0) -> dict:
    """The counters of `steps` PE NeRF train steps: K1 and K2, K2's delta
    chain and its split-K pass twice per step, K3-K6 never; the fused fp32
    forward once per pass of a PE model that a render made without
    autograd (`renders`, a RenderMeter's count)."""
    return {**{k.__name__: 2 * steps if k in (
        K.nerf_mlp_fwd_save, K.nerf_mlp_bwd_saved) else 0
        for k in K.KERNELS}, "dw_splitk": 2 * steps,
        "nerf_mlp_deltas": 2 * steps, "nerf_mlp_fwd_tf32": renders}


class RenderMeter:
    """``ops/render.render_rays`` as ``render_image`` calls it, counting the
    passes that must go through the fused fp32 forward: each call runs the
    coarse and the fine model once, and a pass does when its model is a PE
    NeRFModel that takes the kernel on the call's input (CUDA float32,
    no autograd: ``nerf_mlp.takes_tf32_kernel``).  The train step calls
    its own import of render_rays, which this leaves alone."""

    def __init__(self, K, fn):
        from msra_practice_project_tpu_torch.models.nerf import NeRFModel
        self.K, self.fn, self.model_cls, self.forwards = K, fn, NeRFModel, 0

    def __call__(self, rays_o, rays_d, near, far, coarse_fn, fine_fn, *args,
                 **kwargs):
        self.forwards += sum(isinstance(f, self.model_cls)
                             and self.K.takes_tf32_kernel(f, rays_o)
                             for f in (coarse_fn, fine_fn))
        return self.fn(rays_o, rays_d, near, far, coarse_fn, fine_fn, *args,
                       **kwargs)


@contextlib.contextmanager
def metered_renders(K):
    """A RenderMeter in ``ops/render.render_rays``' place for the block."""
    from msra_practice_project_tpu_torch.ops import render
    with replaced(render, "render_rays",
                  RenderMeter(K, render.render_rays)) as meter:
        yield meter


def main_path(torch, K, iterations, startup, timed):
    """The main path with every launch counter set to 0 just before it and
    read just after; K1 and K2, K2's delta chain and its split-K pass must
    run twice per step, K3-K6 never, the fused fp32 forward once per pass
    of the closing preview render (and it must have run)."""
    reset_counts()
    with metered_renders(K) as renders:
        ms, batch, log, ckpt, png = run_train(torch, iterations, startup,
                                              timed)
    launches = nerf_launches(K)
    losses = log["loss"]
    rays = batch / (ms / 1e3)
    print(f"  losses first/last {losses[0]:.5f}/{losses[-1]:.5f}, launches "
          f"{launches}, ckpt {ckpt}, png {png}", flush=True)
    print(f"  window of the last {timed} steps (CUDA events): {ms:.3f} "
          f"ms/step, {rays:,.0f} rays/s", flush=True)
    if not (len(losses) == iterations
            and all(v == v and abs(v) != float("inf") for v in losses)
            and launches == nerf_want(K, iterations, renders.forwards)
            and renders.forwards > 0 and ckpt and png):
        raise SystemExit("main path check failed")
    return launches, ms, rays


def load_tool(name):
    """tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


QUALITY_STEPS, QUALITY_SIZE = 3000, 64   # BASELINE.md's analytic recipe
TEST_JSON_KEYS = {"dist", "psnr", "ssim", "lpips", "perceptual",
                  "perceptual_metric"}


def quality_path(torch, K):
    """The NeRF quality gate: tools/torch_validate_nerf.py's main on the
    easy analytic scene (3000 steps at 64x64, run in this process), with
    every launch counter set to 0 just before it and read just after: K1
    and K2, K2's delta chain and its split-K pass twice per step, K3-K6
    never, the fused fp32 forward once per pass of its renders of the
    trained field.  Test PSNR must exceed the tool's 28 dB.  Then
    eval.test_nerf.run on the trained experiment (2 views per split), whose
    test.json must hold the JAX test_nerf's keys, lpips null (no weights) and
    perceptual_metric "1-msssim"."""
    from msra_practice_project_tpu_torch.eval import test_nerf
    tool = load_tool("torch_validate_nerf")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quality_") as out, \
            metered_renders(K) as renders:
        reset_counts()
        res = tool.main(QUALITY_STEPS, QUALITY_SIZE, "easy", out_dir=out)
        torch.cuda.synchronize()
        launches = nerf_launches(K)
        forwards = renders.forwards
        steps = res["steps"]
        gate_s = time.perf_counter() - t0
        data = test_nerf.run(res["log_path"], None, max_views=2)
        with open(os.path.join(res["log_path"], "test.json")) as f:
            written = json.load(f)
    seconds = time.perf_counter() - t0
    q = {"steps": steps, "size": QUALITY_SIZE, "scene": "easy",
         "train_psnr": res["train"][0], "train_ssim": res["train"][1],
         "test_psnr": res["test"][0], "test_ssim": res["test"][1],
         "ms_per_step": res["ms_per_step"], "gate_seconds": gate_s,
         "phase_seconds": seconds,
         "test_nerf_psnr_train": data["psnr"]["train"],
         "test_nerf_psnr_in": data["psnr"]["in"],
         "test_nerf_perceptual_metric": data["perceptual_metric"]}
    print(f"  train PSNR {q['train_psnr']:.3f} dB SSIM "
          f"{q['train_ssim']:.4f}; test PSNR {q['test_psnr']:.3f} dB SSIM "
          f"{q['test_ssim']:.4f}; {q['ms_per_step']:.3f} ms/step (CUDA "
          f"events over all {steps} steps); gate {gate_s:.1f} s (dataset, "
          f"training, eval), phase "
          f"{seconds:.1f} s; launches {launches}", flush=True)
    want = nerf_want(K, steps, forwards)
    if launches != want or not forwards:
        raise SystemExit(f"quality path launches {launches} != {want}")
    if not res["test"][0] > tool.PASS_DB:
        raise SystemExit(f"NeRF quality gate failed: test PSNR "
                         f"{res['test'][0]:.3f} dB <= {tool.PASS_DB} dB")
    views = [v for split in ("train", "in", "ex")
             for v in written["psnr"][split]]
    if not (set(written) == TEST_JSON_KEYS and views
            and all(v == v and abs(v) != float("inf") for v in views)
            and all(v is None for split in ("train", "in", "ex")
                    for v in written["lpips"][split])
            and written["perceptual_metric"] == "1-msssim"):
        raise SystemExit(f"test.json check failed: {written}")
    return q


def roofline_path(torch, K, tool):
    """The path of K3-K6: the roofline tool at ROOFLINE_BATCH, both modes,
    in this process, with every launch counter set to 0 just before it and
    read just after.  Fails unless fused_nerf_apply at its defaults
    launched K3 1 time per forward and K3, K5, K4 1 time each per forward +
    backward (K5 and K4 per backward alone), the train step K1 and K2 twice,
    fwdwall K6, the split-K pass once per K2 and once per K5 chunk, and
    every time is a positive finite number."""
    reset_counts()
    main = tool.run(ROOFLINE_BATCH, "main")
    wall = tool.run(ROOFLINE_BATCH, "fwdwall")
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in K.KERNELS}
    n = ROOFLINE_BATCH * tool.PTS_PER_RAY
    launches["dw_splitk"] = dw = dw_launches()
    want_dw = (launches["nerf_mlp_bwd_saved"]
               + launches["nerf_mlp_bwd"] * -(-n // K.chunk_rows(n, True)))
    per_call = {**main["launches"],
                **{f"fwdwall_{k}": v for k, v in wall["launches"].items()}}
    want = {"step": {"nerf_mlp_fwd_save": 2, "nerf_mlp_bwd_saved": 2},
            "mlp_fwd": {"nerf_mlp_fwd": 1},
            "mlp_bwd": {"nerf_mlp_bwd": 1, "nerf_mlp_dx": 1},
            "mlp_fwd_bwd": {"nerf_mlp_fwd": 1, "nerf_mlp_bwd": 1,
                            "nerf_mlp_dx": 1},
            "fwdwall_k3": {"nerf_mlp_fwd": 1},
            "fwdwall_k6": {"nerf_mlp_fwd_pipelined": 1}}
    times = [v for r in (main, wall) for k, v in r.items()
             if k.endswith("_ms")]
    print(f"  launches per call {per_call}; over the path {launches}",
          flush=True)
    if not (all(per_call[k] == v for k, v in want.items())
            and dw == want_dw and all(0 < t < float("inf") for t in times)):
        raise SystemExit("roofline path check failed")
    return launches, main, wall


def is_port_kernel(name: str) -> bool:
    """A kernel of the port's csrc/*.cu (its anonymous namespace or
    tile_mm.cuh), not one of PyTorch's or cuDNN's."""
    return name.startswith(("void (anonymous namespace)::",
                            "(anonymous namespace)::", "tile_mm::",
                            "void tile_mm::"))


def profile_report(prof, timed, ms, unit):
    """From a torch.profiler run over a window of `timed` steps that took
    `ms` per step: the device's busy time per step (union of its kernel
    intervals) and the window's idle share; prints them with the time of
    the port's kernels and the largest kernels by name."""
    events = device_kernels(prof)
    if not events:
        raise SystemExit("the profiler saw no device kernel in the window")
    busy_us, end = 0.0, float("-inf")
    by_name: dict = {}
    for name, ts, dur in sorted(events, key=lambda e: e[1]):
        lo, hi = max(ts, end), ts + dur
        if hi > lo:
            busy_us += hi - lo
        end = max(end, hi)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + dur / 1e3, n + 1)
    busy = busy_us / 1e3 / timed
    idle = max(0.0, 1 - busy / ms)
    port = sum(t for name, (t, _) in by_name.items()
               if is_port_kernel(name)) / timed
    print(f"  window of {timed} {unit}s, profiler on: {ms:.3f} ms/{unit}; "
          f"device busy {busy:.3f} ms/{unit} ({port:.3f} of it the port's "
          f"kernels), idle share {idle:.3f}", flush=True)
    rows = sorted(((t / timed, n / timed, name)
                   for name, (t, n) in by_name.items()), reverse=True)
    for t, n, name in rows[:12]:
        print(f"  {t:8.4f} ms/{unit}  x{n:<5g} {name[:100]}", flush=True)
    return busy, idle, by_name


def kernel_by_name(by_name, key, timed):
    """One kernel's device time from a profile's {name: (ms, count)}: the
    names that contain `key`, per iteration of `timed` and per launch."""
    ms = sum(t for name, (t, _) in by_name.items() if key in name)
    n = sum(c for name, (_, c) in by_name.items() if key in name)
    return {"ms_per_iteration": ms / timed,
            "launches_per_iteration": n / timed,
            "ms_per_launch": ms / n if n else None}


# The NeRF step's kernels reported by name from its profile: K1's bf16
# per-tile kernel, K2's delta chain and K2's split-K pass.
NERF_PROFILED = ("nerf_fwd_tc_kernel", "nerf_bwd_delta_tc_kernel",
                 "dw_splitk_tc_kernel")


def profiled_window(torch, iterations, startup, timed):
    """The same train run with torch.profiler (device activity only) on for
    the timed window: busy, wall and idle share of that one window, and the
    NERF_PROFILED kernels' device time per step."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    ms = run_train(torch, iterations, startup, timed, window=prof)[0]
    busy, idle, by_name = profile_report(prof, timed, ms, "step")
    named = {}
    for key in NERF_PROFILED:
        named[key] = d = kernel_by_name(by_name, key, timed)
        print(f"  {key}: {d['ms_per_iteration']:.3f} ms/step in "
              f"{d['launches_per_iteration']:g} launches", flush=True)
        if not d["launches_per_iteration"]:
            raise SystemExit(f"{key} not seen in the NeRF profile")
    return ms, busy, idle, named


# The fp32 CUDA-core peak of an H100 SXM (NVIDIA data sheet), for the
# polynomial sines: 15 fp32 operations each, derivative or value
# (csrc/film_mlp.cu: 6 of range reduction, 9 of polynomial).
FP32_FLOP_PER_S = 67e12
SINE_OPS = 15


def film_macs():
    """Multiply-adds per point of the FiLM trunk (unpadded): K8's forward,
    and K7's (recomputed forward, the dh chain, dW; no dx)."""
    fwd = 3 * 256 + 7 * 256 * 256 + 256 * 256 + 3 * 256 + 256 * 1 + 256 * 3
    chain = 256 * 3 + 256 * 256 + 256 * 1 + 7 * 256 * 256
    return fwd, 2 * fwd + chain


def film_bounds(FK, n_img, n_pts, w, ops=(SINE_OPS, SINE_OPS)):
    """(K8 ms, K8 bound_by, K7 ms, K7 bound_by): the least time for the work
    of one launch, the larger of its bytes over HBM's rate, its MACs over
    the bf16 tensor-core rate and its sines over the fp32 rate, at `ops`
    (sine, derivative) operations each."""
    wbytes = sum(t.numel() * t.element_size() for t in w)
    film_bytes = n_img * FK.N_FILM * 2 * FK.HID * 4
    n = n_img * n_pts
    fwd_macs, bwd_macs = film_macs()
    out = []
    for b, macs, sine_ops in (
            (n * 64 + wbytes + film_bytes, fwd_macs, 2304 * ops[0]),
            (n * 64 + wbytes + 2 * film_bytes + FK.GRAD_TOTAL * 4, bwd_macs,
             2304 * (ops[0] + ops[1]))):
        t = {"bytes": b / HBM_BYTES_PER_S * 1e3,
             "operations": max(2 * macs * n / BF16_FLOP_PER_S,
                               sine_ops * n / FP32_FLOP_PER_S) * 1e3}
        by = max(t, key=t.get)
        out += [t[by], by]
    return out


def film_f32_bound(FK, n_img, n_pts, w, sin_ops=SINE_OPS):
    """(K8 fp32 bound ms, bound_by, FMA ms): the least time for one fp32 K8
    launch, the larger of its bytes over HBM's rate and its operations over
    their peak rates (3 tf32 passes of every MAC over the tf32 tensor-core
    rate, the sines over the fp32 rate), and the same MACs as FMA on the
    CUDA cores."""
    wbytes = sum(t.numel() * t.element_size() for t in w)
    n = n_img * n_pts
    macs = film_macs()[0]
    t = {"bytes": (n * 64 + wbytes + n_img * FK.N_FILM * 2 * FK.HID * 4)
         / HBM_BYTES_PER_S * 1e3,
         "operations": max(3 * 2 * macs * n / TF32_FLOP_PER_S,
                           sin_ops * 2304 * n / FP32_FLOP_PER_S) * 1e3}
    by = max(t, key=t.get)
    return t[by], by, 2 * macs * n / FP32_FLOP_PER_S * 1e3


def time_film(torch, FK, n_img, n_pts, reps, side=32,
              ops=(SINE_OPS, SINE_OPS)):
    """K8 and K7 (bf16, need_dx=False as the generator calls it) per launch
    beside their plain versions (sliced over images) and their bounds, the
    sines at `ops` (sine, derivative) operations each; the sine the
    switch (core.nn.USE_FAST_SIN) selects."""
    x, film, w, dy = film_inputs(torch, FK, n_img, n_pts, seed=1, res=side)
    x, film, dy = x.cuda(), film.cuda(), dy.cuda()
    wk = [t.cuda() for t in FK.kernel_weights(w, True)]

    def plain_fwd():
        for lo in range(0, n_img, FILM_SLICE):
            sl = slice(lo, lo + FILM_SLICE)
            FK.film_mlp_fwd_plain(x[sl], film[sl], wk, True)

    res = {
        "fwd_ms": time_ms(torch, lambda: FK.film_mlp_fwd(x, film, wk, True),
                          reps),
        "fwd_plain_ms": time_ms(torch, plain_fwd, 3),
        "bwd_ms": time_ms(torch, lambda: FK.film_mlp_bwd(
            x, film, dy, wk, True, False), reps),
        "bwd_plain_ms": time_ms(torch, lambda: film_plain_sliced(
            torch, FK, x, film, dy, wk, True, False), 3),
    }
    # K8 in fp32 (the fp32 check mode), beside the plain fp32 forward
    wf = [t.cuda() for t in FK.kernel_weights(w, False)]

    def plain_fwd_f32():
        for lo in range(0, n_img, FILM_SLICE):
            sl = slice(lo, lo + FILM_SLICE)
            FK.film_mlp_fwd_plain(x[sl], film[sl], wf, False)

    res["fwd_f32_ms"] = time_ms(torch, lambda: FK.film_mlp_fwd(
        x, film, wf, False), reps)
    res["fwd_f32_plain_ms"] = time_ms(torch, plain_fwd_f32, 3)
    (res["fwd_f32_bound_ms"], res["fwd_f32_bound_by"],
     res["fwd_f32_fma_ms"]) = film_f32_bound(FK, n_img, n_pts, wf, ops[0])
    b1, by1, b2, by2 = film_bounds(FK, n_img, n_pts, wk, ops)
    res.update(fwd_bound_ms=b1, fwd_bound_by=by1, bwd_bound_ms=b2,
               bwd_bound_by=by2)
    return res


def run_pigan(torch, FK, mode, overrides, timed, window_end, window=None):
    """train_pigan.train on configs/pi_gan/test.json with `overrides`, in
    trunk mode `mode` (MSRA_TPU_FUSED_FILM, unset for the default mode 1),
    in a temporary directory; the launch counters are set to 0 just before
    it and read just after.  Iterations window_end - timed + 1 ..
    window_end are one window timed with CUDA events, with `window` entered
    for them.  Returns (ms per iteration, launches, loss log, checkpoint
    written, PNG written, the launches the demo grids made: counted around
    each save_demo_grid call)."""
    from msra_practice_project_tpu_torch.core.config import (
        CONFIG_ROOT, PIGAN_TRAIN_DEFAULTS, load_config, resolve)
    from msra_practice_project_tpu_torch.train import train_pigan

    cfg = resolve(load_config(os.path.join(CONFIG_ROOT, "pi_gan",
                                           "test.json")),
                  PIGAN_TRAIN_DEFAULTS)
    old = os.environ.pop("MSRA_TPU_FUSED_FILM", None)
    if mode != 1:  # mode 1 is the default on CUDA: the variable stays unset
        os.environ["MSRA_TPU_FUSED_FILM"] = str(mode)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir, \
                metered(FK, train_pigan, "save_demo_grid") as grid:
            cfg.update(output_path=out_dir, experiment_name="pigan_smoke",
                       **overrides)
            reset_counts()
            res = train_pigan.train(cfg, timed_steps=timed,
                                    window_end=window_end, window=window)
            torch.cuda.synchronize()
            launches = {k.__name__: k.launches for k in FK.KERNELS}
            launches["film_mlp_fwd_f32"] = FK.film_mlp_fwd.launches_f32
            for k in FK.KERNELS:
                launches[k.__name__ + "_exact"] = k.launches_exact
            launches["dw_splitk"] = dw_launches()
            last = cfg["iterations"][-1]
            log = os.path.join(out_dir, "pigan_smoke")
            ckpt = os.path.exists(os.path.join(log, f"{last:06d}.ckpt"))
            png = os.path.exists(os.path.join(log, f"{last:06d}.png"))
    finally:
        os.environ.pop("MSRA_TPU_FUSED_FILM", None)
        if old is not None:
            os.environ["MSRA_TPU_FUSED_FILM"] = old
    demo = {k: grid.counts[k] for k in ("film_mlp_fwd", "film_mlp_fwd_f32")}
    return res["window_ms"] / timed, launches, res["loss_log"], ckpt, png, demo


def pigan_path(torch, FK, mode, overrides, timed, window_end, want,
               files=False):
    """One pi-GAN run; fails unless every loss is finite, each kernel
    launched `want[name]` times per iteration besides the launches counted
    around the demo grids (K8 in mode 1's fp32 only, at least one when a
    grid is written, and none in mode 0), the split-K pass at least once
    per K7 launch (once per chunk of images) and, with `files`, the last
    iteration wrote its checkpoint and its demo grid."""
    ms, launches, log, ckpt, png, demo = run_pigan(
        torch, FK, mode, overrides, timed, window_end)
    n_it = overrides["iterations"][-1]
    # the window's stage: test.json's batch sizes unless overridden
    batch = overrides.get("batch_size", [64, 16])[
        sum(window_end > i for i in overrides["iterations"][:-1])]
    losses = log["d_loss"] + log["g_loss"]
    finite = (len(losses) == 2 * n_it
              and all(v == v and abs(v) != float("inf") for v in losses))
    per_it = {k: (v - demo.get(k, 0)) / n_it
              for k, v in launches.items() if k != "dw_splitk"}
    demo_ok = (demo["film_mlp_fwd_f32"]
               == demo["film_mlp_fwd"] * (mode == 1)
               and (demo["film_mlp_fwd"] == 0 if mode == 0
                    else demo["film_mlp_fwd"] > 0 or not files))
    print(f"  mode {mode}: d_loss first/last {log['d_loss'][0]:.4f}/"
          f"{log['d_loss'][-1]:.4f}, g_loss first/last "
          f"{log['g_loss'][0]:.4f}/{log['g_loss'][-1]:.4f}, finite {finite}, "
          f"launches {launches} ({per_it} per iteration besides the demo "
          f"grids' {demo}), ckpt {ckpt}, png {png}", flush=True)
    print(f"  mode {mode}: window of iterations {window_end - timed + 1}-"
          f"{window_end} (CUDA events): {ms:.3f} ms/iteration, "
          f"{batch / (ms / 1e3):.1f} images/s", flush=True)
    if not (finite and per_it == want and demo_ok
            and (ckpt and png or not files)
            and launches["dw_splitk"] >= launches["film_mlp_bwd"]):
        raise SystemExit(f"pi-GAN mode {mode} check failed")
    return ms, launches, ckpt, png


# Slice 11: pi-GAN's quality gate, its eval stack, mesh extraction and
# latent inversion, all at B = 1 image per trunk call except the gate's
# training.  Synthesis renders 64x64 with 8 + 16 samples (coarse and fine
# pass: P 32,768 and 98,304); extract_mesh's slice is 256 x 256 points.
SYN_SHAPES = ((1, 64 * 64 * 8), (1, 64 * 64 * 24))
MESH_N = 256
MESH_SHAPE = (1, MESH_N * MESH_N)
SYN_ITERATIONS = 1000     # the JAX default is 5000 (cut for the run's time)
SYN_PROFILED = range(501, 521)   # synthesis steps traced by torch.profiler
DEMO_MODES = range(7)


def check_mesh_slice(torch, FK):
    """K8 (fp32, as mode 1 runs it, and bf16) on extract_mesh's grid slice
    (B 1 x P 65,536: positions in the +-0.1 cube, directions zero) against
    its plain version, 1e-4 of max|ref| in fp32 and 2e-2 relative Frobenius
    in bf16, and bitwise repeats.  Returns the max |err| per precision."""
    from msra_practice_project_tpu_torch.eval import extract_mesh
    from msra_practice_project_tpu_torch.models import pigan

    g = torch.Generator().manual_seed(4)
    gen = pigan.Generator(pigan.GeneratorConfig(), generator=g)
    with torch.no_grad():
        film = gen.mapping(torch.randn(1, gen.cfg.z_dim, generator=g))
    x = FK.pad_points(extract_mesh.slice_points(0.03, MESH_N), 1)[0]
    packed = FK.pack_film_params(dict(gen.trunk.named_parameters()), True)
    w = [packed[k].detach() for k in FK.PACK_KEYS]
    x, film = x.cuda(), film.contiguous().cuda()
    out = {}
    for bf16 in (False, True):
        wk = [t.cuda() for t in FK.kernel_weights(w, bf16)]
        got = FK.film_mlp_fwd(x, film, wk, bf16)
        same = torch.equal(got, FK.film_mlp_fwd(x, film, wk, bf16))
        ref = FK.film_mlp_fwd_plain(x, film, wk, bf16)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        r = rel_frob(got, ref) if bf16 else err / max(
            float(ref.abs().max()), 1e-30)
        gate = FILM_GATES[bf16]["fwd"]
        print(f"  mesh slice B=1 P={x.shape[1]} bf16={bf16}: max|err| "
              f"{err:.3e}, {'rel frob' if bf16 else 'err/max'} {r:.3e} "
              f"(gate {gate:g}), max|ref| {float(ref.abs().max()):.3e}, "
              f"bitwise repeat {same}", flush=True)
        if not (r <= gate and same):
            raise SystemExit("K8 disagrees with its plain version on the "
                             "mesh slice")
        out["film_mlp_fwd" if bf16 else "film_mlp_fwd_f32"] = err
    return out


def film_launches(FK):
    return {"film_mlp_fwd": FK.film_mlp_fwd.launches,
            "film_mlp_fwd_f32": FK.film_mlp_fwd.launches_f32,
            "film_mlp_bwd": FK.film_mlp_bwd.launches,
            "dw_splitk": dw_launches()}


def pigan_quality(torch, FK):
    """tools/torch_validate_pigan.py at its defaults (1200 iterations of
    batch 16 at 32x32, 128 shaded images, z 256, 8 + 16 samples) in mode 1,
    in this process, with the counters set to 0 just before it.  Fails
    unless the training launched K8 (all fp32) 4 times and K7 once per
    iteration, and four of the JAX tool's gates hold, each recorded passing
    at this recipe by the JAX package: hist improves >= 34%, diversity >
    0.02, yaw delta in (1e-4, 0.3), finite losses with |g| tail < 50.  The
    tool's other gates and its verdict are readings."""
    from msra_practice_project_tpu_torch.train import train_pigan

    tool = load_tool("torch_validate_pigan")
    reset_counts()
    t0 = time.perf_counter()
    with metered(FK, train_pigan, "train") as trained, \
            metered(FK, train_pigan, "save_demo_grid") as grid:
        r = tool.main()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = film_launches(FK)
    n_it = r["iterations"]
    per_it = {k: (trained.counts[k] - grid.counts[k]) / n_it
              for k in ("film_mlp_fwd", "film_mlp_fwd_f32", "film_mlp_bwd")}
    hard = {
        "hist improves >= 34%": r["hist1"] < 0.66 * r["hist0"],
        "diversity > 0.02": r["diversity"] > 0.02,
        "yaw delta in (1e-4, 0.3)": 1e-4 < r["yaw_delta"] < 0.3,
        "losses finite, |g| tail < 50": r["finite"] and r["g_tail"] < 50.0,
    }
    readings = {k: v for k, v in r.items()
                if k not in ("loss_log", "exp_dir")}
    for k, v in readings.items():
        print(f"  {k}: {v}", flush=True)
    print(f"  trained-D Frechet / floor: "
          f"{r['d_frechet1'] / max(r['d_frechet_floor'], 1e-9):.2f}x (bar "
          f"30x); rf-Frechet ratio {r['rf_frechet1'] / r['rf_frechet0']:.4f}"
          f" (bar 0.5); trained-D ratio "
          f"{r['d_frechet1'] / r['d_frechet0']:.4f} (bar 0.5); low-freq "
          f"structure {r['lowfreq1'] / r['lowfreq_real']:.4f} of real (bar "
          f"0.4)", flush=True)
    print(f"  the tool's verdict: {'PASS' if r['pass'] else 'FAIL'}",
          flush=True)
    print(f"  launches: {total} in all; per training iteration {per_it} "
          f"(besides the demo grids' {grid.counts}); {seconds:.1f} s",
          flush=True)
    for k, ok in hard.items():
        print(f"  gate {k}: {'ok' if ok else 'FAIL'}", flush=True)
    if per_it != {"film_mlp_fwd": 4.0, "film_mlp_fwd_f32": 4.0,
                  "film_mlp_bwd": 1.0} or \
            total["dw_splitk"] < total["film_mlp_bwd"]:
        raise SystemExit("the pi-GAN gate's training did not run K8 in "
                         "fp32 4 times and K7 once per iteration")
    if not all(hard.values()):
        raise SystemExit("pi-GAN quality gate failed")
    readings.update(seconds=seconds, launches=total,
                    launches_per_iteration=per_it, hard_gates=hard)
    return r["exp_dir"], readings


def _expect_k8_only(counts, what, exact=None):
    """Fail unless `counts` shows K8 launched (all fp32; `exact` times when
    given) and K7 never."""
    k8 = counts["film_mlp_fwd"]
    if not (k8 > 0 and counts["film_mlp_fwd_f32"] == k8
            and counts["film_mlp_bwd"] == 0
            and (exact is None or k8 == exact)):
        raise SystemExit(f"{what}: K8 launches {counts} (want fp32 only"
                         + (f", {exact}" if exact else "") + ", no K7)")


def pigan_eval(torch, FK, exp_dir):
    """On the gate's experiment: eval.pigan_test.run, pigan_demo modes 0-6
    (mode 0 at 64x64, the rest at 128x128, 32 + 64 samples) and
    extract_mesh at n 256 (level -20), each through K8 in fp32 with the
    counters set to 0 just before it; seconds per part."""
    import numpy as np
    from msra_practice_project_tpu_torch.core.config import (
        PIGAN_TRAIN_DEFAULTS)
    from msra_practice_project_tpu_torch.core import mesh as mesh_lib
    from msra_practice_project_tpu_torch.eval import (extract_mesh,
                                                      pigan_demo, pigan_test)
    from msra_practice_project_tpu_torch.train import common

    cfg = common.parse_cli([os.path.join(exp_dir, "config.json")],
                           PIGAN_TRAIN_DEFAULTS)
    out = {}

    def timed(fn):
        reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, film_launches(FK)

    r, sec, n = timed(lambda: pigan_test.run(cfg))
    _expect_k8_only(n, "pigan_test.run")
    out["pigan_test"] = {
        "seconds": sec, "launches": n, "resolution": r["resolution"],
        "gen_logits_mean": float(r["gen_logits"].mean()),
        "real_logits_mean": float(r["real_logits"].mean()),
        "rf_frechet": r["rf_frechet"],
        "spatial_std_real": r["spatial_std_real"],
        "spatial_std_gen": r["spatial_std_gen"]}
    print(f"  pigan_test.run: {out['pigan_test']}", flush=True)

    demos = {}
    for mode in DEMO_MODES:
        path, sec, n = timed(lambda: pigan_demo.run(cfg, mode))
        _expect_k8_only(n, f"demo mode {mode}")
        if not os.path.getsize(path):
            raise SystemExit(f"demo mode {mode} wrote no file")
        demos[mode] = {"seconds": sec, "k8_launches": n["film_mlp_fwd"],
                       "file": os.path.basename(path)}
        print(f"  demo mode {mode}: {sec:.2f} s, K8 {n['film_mlp_fwd']} "
              f"launches (fp32), {os.path.basename(path)}", flush=True)
    out["demo"] = demos

    g, _, step = pigan_demo.load_generator(cfg)
    dev = next(g.parameters()).device
    with torch.no_grad():
        film = g.get_mapping(torch.randn(
            1, g.cfg.z_dim, device=dev, generator=torch.Generator(
                device=dev).manual_seed(extract_mesh.MESH_SEED)))
    values, grid_s, n = timed(lambda: extract_mesh.sigma_grid(g, film,
                                                              MESH_N))
    _expect_k8_only(n, "extract_mesh's sigma grid", exact=MESH_N)
    t0 = time.perf_counter()
    verts, faces = extract_mesh.march(
        values, os.path.join(exp_dir, f"mesh_{step:06d}"))
    march_s = time.perf_counter() - t0
    finite = bool(np.isfinite(values).all())
    out["mesh"] = {"n": MESH_N, "grid_seconds": grid_s,
                   "march_seconds": march_s, "k8_launches": n["film_mlp_fwd"],
                   "verts": int(verts.shape[0]), "faces": int(faces.shape[0]),
                   "sigma_min": float(-values.max()),
                   "sigma_max": float(-values.min()), "finite": finite,
                   "native_marching": mesh_lib._load_native() is not None}
    print(f"  extract_mesh n={MESH_N}: {out['mesh']}", flush=True)
    if not (finite and values.shape == (MESH_N,) * 3):
        raise SystemExit("extract_mesh's sigma grid is not finite")
    return out


def pigan_synthesis(torch, FK, exp_dir):
    """train.synthesis on the gate's checkpoint: self-inversion of a
    generated sample for SYN_ITERATIONS steps in mode 1, each step timed
    with CUDA events and its K8/K7 launches counted (the counters set to 0
    just before the run), SYN_PROFILED's steps traced by torch.profiler.  Fails unless every logged loss is finite, the
    mean of the last 100 is below that of the first 100, and each step
    launched K8 in fp32 4 times and K7 twice (the fine pass of both
    renders)."""
    import numpy as np
    from msra_practice_project_tpu_torch.core.config import (
        PIGAN_TRAIN_DEFAULTS)
    from msra_practice_project_tpu_torch.train import common, synthesis

    cfg = common.parse_cli([os.path.join(exp_dir, "config.json"),
                            f"syn_iterations={SYN_ITERATIONS}"],
                           PIGAN_TRAIN_DEFAULTS)
    from torch.profiler import ProfilerActivity, profile

    make_step, meters = synthesis.make_syn_step, []
    prof = profile(activities=[ProfilerActivity.CUDA])

    def metered_make(*args, **kwargs):
        meters.append(LaunchMeter(FK, make_step(*args, **kwargs), True))

        def step(**kw):   # the profiler on for SYN_PROFILED's steps
            n = meters[0].counts["calls"] + 1
            if n == SYN_PROFILED.start:
                torch.cuda.synchronize()
                prof.__enter__()
            out = meters[0](**kw)
            if n == SYN_PROFILED.stop - 1:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
            return out
        return step

    reset_counts()
    t0 = time.perf_counter()
    with replaced(synthesis, "make_syn_step", metered_make), \
            metered(FK, synthesis, "demo_multiview", True) as mv, \
            metered(FK, synthesis, "demo_video", True) as gif:
        r = synthesis.synthesize(cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps = meters[0]
    losses = np.asarray(r["loss_log"], np.float64)
    n = steps.counts["calls"]
    # ms per step over the unprofiled steps after the first 10; the
    # profiled window's wall time from its first step's start to its last
    # step's end
    ev = steps.events
    unprofiled = [a.elapsed_time(b) for i, (a, b) in enumerate(ev)
                  if i >= 10 and i + 1 not in SYN_PROFILED]
    win = ev[SYN_PROFILED.start - 1][0].elapsed_time(
        ev[SYN_PROFILED.stop - 2][1]) / len(SYN_PROFILED)
    busy, idle, by_name = profile_report(prof, len(SYN_PROFILED), win,
                                         "step")
    per_step = {k: steps.counts[k] / n for k in
                ("film_mlp_fwd", "film_mlp_fwd_f32", "film_mlp_bwd")}
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    out = {
        "iterations": n, "ms_per_step": sum(unprofiled) / len(unprofiled),
        "profiled_ms_per_step": win, "device_busy_ms_per_step": busy,
        "profiled_idle_share": idle,
        "k7_delta_kernel_ms_per_step": kernel_by_name(
            by_name, TC_KERNELS[0], len(SYN_PROFILED))["ms_per_iteration"],
        "k8_tf32_kernel_ms_per_step": kernel_by_name(
            by_name, TF32_KERNEL, len(SYN_PROFILED))["ms_per_iteration"],
        "launches_per_step": per_step, "launches": film_launches(FK),
        "loss_first100": first, "loss_last100": last,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        # the last multiview is the final 128x128 one
        "final_multiview_s": mv.ms(skip=mv.counts["calls"] - 1) / 1e3,
        "gif_s": gif.ms() / 1e3, "seconds": seconds}
    print(f"  synthesis: {out}", flush=True)
    if not (len(losses) == SYN_ITERATIONS and np.isfinite(losses).all()
            and last < first):
        raise SystemExit("synthesis: the loss is not finite or did not "
                         "fall")
    if per_step != {"film_mlp_fwd": 4.0, "film_mlp_fwd_f32": 4.0,
                    "film_mlp_bwd": 2.0}:
        raise SystemExit(f"synthesis step launches {per_step}")
    return out


@contextlib.contextmanager
def run_root_at(root):
    """MSRA_TPU_RUN_ROOT set to `root` for the block."""
    old = os.environ.get("MSRA_TPU_RUN_ROOT")
    os.environ["MSRA_TPU_RUN_ROOT"] = root
    try:
        yield root
    finally:
        os.environ.pop("MSRA_TPU_RUN_ROOT", None)
        if old is not None:
            os.environ["MSRA_TPU_RUN_ROOT"] = old


def pigan_rest(torch, FK, summary, kernels, runs):
    """Phases 17-20: K8/K7 at B = 1, the pi-GAN quality gate (its
    experiment in the run root `runs`), its eval stack and synthesis; their
    numbers go into `summary`, and the K7/K8 entries of `kernels` gain
    their B = 1 rows and launches by path.  Returns the gate's experiment
    directory."""
    b1_errs = {}
    for n_img, n_pts in SYN_SHAPES:
        phase(f"K7/K8 vs plain versions at B={n_img}, P={n_pts} (synthesis: "
              "one 64x64 image)")
        for name, err in check_film(torch, FK, n_img, n_pts, 64).items():
            b1_errs[name] = max(err, b1_errs.get(name, 0.0))
        torch.cuda.synchronize()
    phase(f"K8 vs plain version on extract_mesh's slice: B={MESH_SHAPE[0]}, "
          f"P={MESH_SHAPE[1]}")
    mesh_errs = check_mesh_slice(torch, FK)
    phase("K7/K8 timings at B=1 (CUDA events, median)")
    b1_times = {}
    for label, (n_img, n_pts), side in (
            ("syn_coarse", SYN_SHAPES[0], 64), ("syn_fine", SYN_SHAPES[1], 64),
            ("mesh", MESH_SHAPE, MESH_N // 8)):
        b1_times[label] = t = time_film(torch, FK, n_img, n_pts, 10, side)
        print(f"  {label} B={n_img} P={n_pts}: K8 fp32 {t['fwd_f32_ms']:.4f} "
              f"ms (plain {t['fwd_f32_plain_ms']:.4f}, bound "
              f"{t['fwd_f32_bound_ms']:.4f} {t['fwd_f32_bound_by']}); K8 bf16 "
              f"{t['fwd_ms']:.4f} (plain {t['fwd_plain_ms']:.4f}, bound "
              f"{t['fwd_bound_ms']:.4f}); K7 {t['bwd_ms']:.4f} (plain "
              f"{t['bwd_plain_ms']:.4f}, bound {t['bwd_bound_ms']:.4f} "
              f"{t['bwd_bound_by']})", flush=True)
        torch.cuda.synchronize()

    # the gate's experiment lives in the caller's temporary run root; mode
    # 1 (the default on CUDA) with MSRA_TPU_FUSED_FILM unset
    old_mode = os.environ.pop("MSRA_TPU_FUSED_FILM", None)
    with run_root_at(runs):
        try:
            phase("pi-GAN quality: tools/torch_validate_pigan.py at its "
                  "defaults (1200 iterations, batch 16 at 32x32, mode 1)")
            exp_dir, quality = pigan_quality(torch, FK)
            phase("pi-GAN eval on the gate's experiment: pigan_test, demo "
                  f"modes 0-6, extract_mesh at n={MESH_N}")
            pigan_ev = pigan_eval(torch, FK, exp_dir)
            phase(f"synthesis on the gate's checkpoint: self-inversion, "
                  f"{SYN_ITERATIONS} steps at 64x64 (mode 1)")
            syn = pigan_synthesis(torch, FK, exp_dir)
        finally:
            if old_mode is not None:
                os.environ["MSRA_TPU_FUSED_FILM"] = old_mode
    summary.update(pigan_quality=quality, pigan_eval=pigan_ev,
                   synthesis=syn, b1_errors={**b1_errs, **{
                       f"mesh_{k}": v for k, v in mesh_errs.items()}})
    by_name = {k["name"]: k for k in kernels}
    k7, k8 = by_name["film_mlp_bwd"], by_name["film_mlp_fwd"]
    b1 = [(f"B={n_img} P={n_pts}", label) for (n_img, n_pts), label in zip(
        (*SYN_SHAPES, MESH_SHAPE), ("syn_coarse", "syn_fine", "mesh"))]
    k7["b1"] = [{"shape": shape, **by_kernel(b1_times[label], "bwd")}
                for shape, label in b1[:2]]
    k7["b1_dfilm_err"] = {"f32_err_over_max": b1_errs["dfilm_f32"],
                          "bf16_rel_frob": b1_errs["dfilm_bf16"]}
    k8["b1"] = [{"shape": shape, **by_kernel(b1_times[label], "fwd")}
                for shape, label in b1]
    k8["f32"]["b1"] = [{"shape": shape, **{
        k: b1_times[label][f"fwd_f32_{k}"]
        for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
        for shape, label in b1]
    k8["f32"]["b1_max_abs_err"] = max(b1_errs["film_mlp_fwd_f32"],
                                      mesh_errs["film_mlp_fwd_f32"])
    k7["launches_by_path"] = {
        "pigan_quality": quality["launches"]["film_mlp_bwd"],
        "synthesis": syn["launches"]["film_mlp_bwd"]}
    k8["f32"]["launches_by_path"] = {
        "pigan_quality": quality["launches"]["film_mlp_fwd_f32"],
        "pigan_test": pigan_ev["pigan_test"]["launches"]["film_mlp_fwd_f32"],
        "demo": sum(d["k8_launches"] for d in pigan_ev["demo"].values()),
        "extract_mesh": pigan_ev["mesh"]["k8_launches"],
        "synthesis": syn["launches"]["film_mlp_fwd_f32"]}
    return exp_dir


# Slice 12: the SIREN stack.  The JAX package runs every SIREN MLP as plain
# XLA, so the port runs them as plain PyTorch in strict fp32 and no kernel
# of the port may launch there.  Image fitting in the four kinds at the
# configs' recipe (batch 65,536 = the 256x256 synthetic image, 3 x 256,
# lr 1e-4), SDF fitting at siren_sdf_1.json's (65,536 on- + 65,536
# off-surface points of the 100,000-point synthetic sphere) in two kinds,
# the SIREN NeRF at lego_siren.json's (1024 rays x 64 + 128 samples), and
# the image and SDF quality gates of the JAX package's tools.  The SIREN
# NeRF gate (tools/torch_validate_nerf.py 5000 64 --siren, ~115 ms a step)
# would take this run past 900 s; it runs by hand (PERF.md).
SIREN_KINDS = ("siren", "tanh", "relu", "relu_pe")
IMG_WARM, IMG_TIMED = 10, 100
SDF_KINDS = ("siren", "relu_pe")
SDF_WARM, SDF_TIMED = 5, 50
# train_sdf's final mesh: n 512, the JAX default, for the siren kind.  The
# relu_pe field after 55 steps still crosses zero in most voxels (its PE
# reaches 2^9 rad per unit): tools/torch_sdf_mesh_sizes.py on an H100 host
# gives 5.6M vertices at n 128 and 40.1M at n 256 (44-53 s of marching, 10
# GiB of host memory), 7.2x per doubling, so ~290M at 512 would take the
# host minutes and tens of GiB.  It meshes at mesh_n's 128.
SDF_MESH_N = {"siren": 512, "relu_pe": 128}
SIREN_WIDTH = 256
IMG_POINTS = 256 * 256      # the synthetic image's pixels: one batch
IMG_GATE_STEPS, SDF_GATE_STEPS = 1500, 4000
# the image gate's --real at the JAX record's recipe (tools/validate_img.py
# 3000 --real, BASELINE.md)
IMG_REAL_STEPS = 3000


def all_launches(K, FK):
    """Every kernel counter of the port: K1-K6 and K2's chain, the split-K
    pass, K8 (all, fp32) and K7."""
    out = {k.__name__: k.launches for k in K.KERNELS}
    out.update(nerf_mlp_deltas=K.nerf_mlp_deltas.launches,
               dw_splitk=dw_launches(),
               film_mlp_fwd=FK.film_mlp_fwd.launches,
               film_mlp_fwd_f32=FK.film_mlp_fwd.launches_f32,
               film_mlp_bwd=FK.film_mlp_bwd.launches)
    return out


def expect_no_launches(K, FK, what, renders=0):
    """No kernel of the port launched, but the fused fp32 forward once per
    pass that a RenderMeter counted (`renders`)."""
    launches = all_launches(K, FK)
    print(f"  kernel launches over {what}: {launches}", flush=True)
    if launches != {**{k: 0 for k in launches}, "nerf_mlp_fwd_tf32": renders}:
        raise SystemExit(f"a kernel of the port launched on {what}: "
                         f"{launches} (renders' passes {renders})")


def is_gemm(name: str) -> bool:
    """A cuBLAS/CUTLASS matrix-product kernel (or its split-K reduction)."""
    n = name.lower()
    return any(k in n for k in ("gemm", "gemv", "splitkreduce", "xmma"))


def gemm_split(by_name, timed):
    """(GEMM ms, the rest's ms) per step from a profile's {name: (ms, n)}:
    sums of kernel times, so overlapping kernels count twice."""
    gemm = sum(t for name, (t, _) in by_name.items() if is_gemm(name))
    rest = sum(t for name, (t, _) in by_name.items() if not is_gemm(name))
    return gemm / timed, rest / timed


def siren_cfg(name, defaults, out_dir, **kw):
    """configs/siren/<name> resolved, in `out_dir`, with `kw` replaced."""
    from msra_practice_project_tpu_torch.core.config import (
        CONFIG_ROOT, load_config, resolve)
    cfg = resolve(load_config(os.path.join(CONFIG_ROOT, "siren", name)),
                  defaults)
    cfg.update(output_path=out_dir, **kw)
    return cfg


def run_siren(torch, trainer, cfg, timed, window=None):
    """trainer.train(cfg) on the card with its last `timed` steps one
    window; returns (its result, ms per step over the window, peak device
    memory in GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = trainer.train(cfg, timed_steps=timed, window=window)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    return res, res["window_ms"] / timed, peak


def finite(values):
    return len(values) > 0 and all(v == v and abs(v) != float("inf")
                                   for v in values)


def mlp_step_flops(n, in_dim, width=SIREN_WIDTH, hidden=3):
    """The products of one forward + backward of the implicit MLP over n
    points (2 FLOPs per MAC; the backward twice the forward, less the first
    layer's input gradient)."""
    macs = in_dim * width + hidden * width * width + width
    return 2 * n * (3 * macs - in_dim * width)


def sine_ms(torch, n, width=SIREN_WIDTH):
    """trunk_sin(30 v) forward + backward on an [n, width] activation
    alone: the unfused sine of one SIREN layer (median of 10, events)."""
    from msra_practice_project_tpu_torch.core.nn import trunk_sin
    gen = torch.Generator(device="cuda").manual_seed(0)
    v = torch.randn((n, width), device="cuda", generator=gen)
    v.requires_grad_()
    g = torch.randn((n, width), device="cuda", generator=gen)

    def fwd_bwd():
        (dv,) = torch.autograd.grad(trunk_sin(30.0 * v), v, g)
        return dv
    return time_ms(torch, fwd_bwd, 10)


def siren_img(torch, out_dir):
    """Phase 21: train_img at each kind's config for IMG_WARM + IMG_TIMED
    steps on the 256x256 synthetic image."""
    from msra_practice_project_tpu_torch.core.config import SIREN_IMG_DEFAULTS
    from msra_practice_project_tpu_torch.train import train_img
    rows = {}
    steps = IMG_WARM + IMG_TIMED
    for kind in SIREN_KINDS:
        cfg = siren_cfg(f"{kind}_img.json", SIREN_IMG_DEFAULTS, out_dir,
                        experiment_name=f"img_{kind}", iterations=steps,
                        i_print=steps, i_save=steps, i_image=steps)
        res, ms, peak = run_siren(torch, train_img, cfg, IMG_TIMED)
        loss, psnr = res["log"]["loss"], res["log"]["psnr"]
        batch = min(cfg["batch_size"], res["width"] * res["height"])
        log = os.path.join(out_dir, f"img_{kind}")
        rows[kind] = r = {
            "ms_per_step": ms, "pixels_per_s": batch / (ms / 1e3),
            "batch": batch, "peak_gib": peak, "loss_first": loss[0],
            "loss_last": loss[-1], "psnr_last": psnr[-1],
            "gemm_flops_per_step": mlp_step_flops(batch, 2 if kind != "relu_pe"
                                                  else 40)}
        print(f"  {kind}: {ms:.3f} ms/step ({IMG_TIMED} steps, CUDA "
              f"events), {r['pixels_per_s']:,.0f} pixels/s, peak "
              f"{peak:.3f} GiB; loss {loss[0]:.5f} -> {loss[-1]:.5f}, PSNR "
              f"{psnr[-1]:.2f} dB", flush=True)
        if not (len(loss) == steps and finite(loss) and loss[-1] < loss[0]
                and os.path.exists(os.path.join(log, f"{steps:06d}.png"))
                and os.path.exists(os.path.join(log, f"{steps:06d}.ckpt"))):
            raise SystemExit(f"SIREN image fit ({kind}) check failed")
    return rows


def siren_sdf(torch, out_dir):
    """Phase 22: train_sdf at siren_sdf_1.json's recipe for SDF_WARM +
    SDF_TIMED steps on the synthetic sphere, then its final mesh at
    SDF_MESH_N; the SDF grid and the marching are timed apart.  The loss
    must be finite and fall (mean of the last 5 below the first 5's)."""
    from msra_practice_project_tpu_torch.core import mesh as mesh_lib
    from msra_practice_project_tpu_torch.core.config import SIREN_SDF_DEFAULTS
    from msra_practice_project_tpu_torch.train import train_sdf
    rows = {}
    steps = SDF_WARM + SDF_TIMED
    for kind in SDF_KINDS:
        cfg = siren_cfg(f"{kind}_sdf_1.json", SIREN_SDF_DEFAULTS, out_dir,
                        experiment_name=f"sdf_{kind}", data_path="",
                        iterations=steps, i_print=steps, i_save=steps,
                        final_mesh_n=SDF_MESH_N[kind])
        seconds = {}

        def timed(key, fn):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                seconds[key] = time.perf_counter() - t0
                return out
            return call
        with replaced(train_sdf, "sdf_grid",
                      timed("grid", train_sdf.sdf_grid)), \
                replaced(mesh_lib, "extract_mesh_from_grid",
                         timed("marching", mesh_lib.extract_mesh_from_grid)):
            res, ms, peak = run_siren(torch, train_sdf, cfg, SDF_TIMED)
        loss = res["log"]["loss"]
        first, last = sum(loss[:5]) / 5, sum(loss[-5:]) / 5
        verts, faces = mesh_lib.read_ply(
            os.path.join(out_dir, f"sdf_{kind}", "test.ply"))
        rows[kind] = r = {
            "ms_per_step": ms, "points_per_step": 2 * cfg["batch_size"],
            "peak_gib": peak, "loss_first": loss[0], "loss_last": loss[-1],
            "loss_first5": first, "loss_last5": last,
            "mesh_n": SDF_MESH_N[kind], "grid_seconds": seconds["grid"],
            "marching_seconds": seconds["marching"],
            "verts": int(verts.shape[0]), "faces": int(faces.shape[0])}
        print(f"  {kind}: {ms:.3f} ms/step ({SDF_TIMED} steps, CUDA "
              f"events), peak {peak:.3f} GiB; loss (mean of 5) {first:.3f} "
              f"-> {last:.3f}; final mesh n={SDF_MESH_N[kind]}: grid "
              f"{r['grid_seconds']:.3f} s, marching "
              f"{r['marching_seconds']:.3f} s, {r['verts']} verts, "
              f"{r['faces']} faces", flush=True)
        if not (len(loss) == steps and finite(loss) and last < first):
            raise SystemExit(f"SIREN SDF fit ({kind}) check failed")
    return rows


def siren_nerf(torch):
    """Phase 23: train_nerf.train at lego_siren.json's recipe, 30 steps
    with the last 20 timed, then again with torch.profiler on for them.
    The loss must be finite and fall (mean of the last 5 below the first
    5's)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.reset_peak_memory_stats()
    ms, batch, log, ckpt, png = run_train(torch, 30, 0, 20,
                                          config="lego_siren.json")
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss = log["loss"]
    first, last = sum(loss[:5]) / 5, sum(loss[-5:]) / 5
    print(f"  {ms:.3f} ms/step (20 steps, CUDA events), "
          f"{batch / (ms / 1e3):,.0f} rays/s, peak {peak:.3f} GiB; loss "
          f"(mean of 5) {first:.5f} -> {last:.5f}; ckpt {ckpt}, png {png}",
          flush=True)
    if not (len(loss) == 30 and finite(loss) and last < first and ckpt
            and png):
        raise SystemExit("SIREN NeRF check failed")
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof_ms = run_train(torch, 30, 0, 20, window=prof,
                        config="lego_siren.json")[0]
    busy, idle, by_name = profile_report(prof, 20, prof_ms, "step")
    gemm, rest = gemm_split(by_name, 20)
    print(f"  device time by kind: GEMM {gemm:.3f} ms/step, the rest "
          f"{rest:.3f}", flush=True)
    return {"ms_per_step": ms, "rays_per_s": batch / (ms / 1e3),
            "peak_gib": peak, "loss_first5": first, "loss_last5": last,
            "profiled_ms_per_step": prof_ms, "busy_ms": busy,
            "idle_share": idle, "gemm_ms": gemm, "rest_ms": rest}


def siren_profiles(torch, out_dir):
    """One profiled window each of the image (siren kind, 10 + 20 steps)
    and the SDF step (siren kind, 5 + 5 steps, a small final mesh), and
    the sine alone at the image step's activation shape."""
    from torch.profiler import ProfilerActivity, profile

    from msra_practice_project_tpu_torch.core.config import (
        SIREN_IMG_DEFAULTS, SIREN_SDF_DEFAULTS)
    from msra_practice_project_tpu_torch.train import train_img, train_sdf
    out = {}
    for label, trainer, cfg, timed in (
            ("img", train_img, siren_cfg(
                "siren_img.json", SIREN_IMG_DEFAULTS, out_dir,
                experiment_name="img_prof", iterations=30, i_print=30,
                i_save=1000, i_image=1000), 20),
            ("sdf", train_sdf, siren_cfg(
                "siren_sdf_1.json", SIREN_SDF_DEFAULTS, out_dir,
                experiment_name="sdf_prof", data_path="", iterations=10,
                i_print=10, i_save=1000, final_mesh_n=32), 5)):
        prof = profile(activities=[ProfilerActivity.CUDA])
        _, ms, _ = run_siren(torch, trainer, cfg, timed, window=prof)
        busy, idle, by_name = profile_report(prof, timed, ms, "step")
        gemm, rest = gemm_split(by_name, timed)
        print(f"  {label} (siren): device time by kind: GEMM {gemm:.3f} "
              f"ms/step, the rest {rest:.3f}", flush=True)
        out[label] = {"profiled_ms_per_step": ms, "busy_ms": busy,
                      "idle_share": idle, "gemm_ms": gemm, "rest_ms": rest}
    n = IMG_POINTS
    out["sine_fwd_bwd_ms"] = t = sine_ms(torch, n)
    print(f"  trunk_sin(30 v) forward + backward alone at [{n}, "
          f"{SIREN_WIDTH}]: {t:.4f} ms (4 per image step)", flush=True)
    return out


def siren_gates(torch, K, FK):
    """Phase 24: the JAX package's SIREN image and SDF quality gates
    through the port's tools, in this process, then eval.test_img and
    eval.test_sdf on their runs.  Fails unless each gate passes."""
    from msra_practice_project_tpu_torch.eval import test_img, test_sdf
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_siren_") as tmp:
        t0 = time.perf_counter()
        img = load_tool("torch_validate_img").main(
            IMG_GATE_STEPS, 64, out_dir=os.path.join(tmp, "img"))
        out["img"] = {"psnr": img["psnr"], "ms_per_step": img["ms_per_step"],
                      "seconds": time.perf_counter() - t0}
        t0 = time.perf_counter()
        sdf = load_tool("torch_validate_sdf").main(
            SDF_GATE_STEPS, out_dir=os.path.join(tmp, "sdf"))
        out["sdf"] = {k: sdf[k] for k in (
            "mean_err", "p95_err", "voxel", "radius", "verts", "faces",
            "loss_first", "loss_last50", "ms_per_step")}
        out["sdf"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        real = load_tool("torch_validate_img").main(
            IMG_REAL_STEPS, 64, real=True,
            out_dir=os.path.join(tmp, "img_real"))
        out["img_real"] = {"psnr": real["psnr"], "bars": real["bars"],
                           "ms_per_step": real["ms_per_step"],
                           "seconds": time.perf_counter() - t0}
        torch.cuda.synchronize()
        expect_no_launches(K, FK, "the SIREN gates")
        strip = test_img.run(os.path.join(tmp, "cmp"),
                             list(img["log_paths"].values()))
        table = test_sdf.run(os.path.join(tmp, "cmp"), [sdf["log_path"]])
        out["eval"] = {"test_img": sorted(strip),
                       "test_sdf_meshes": list(table["meshes"].values())}
    print(f"  gates: {json.dumps(out)}", flush=True)
    if not img["ok"]:
        raise SystemExit(f"SIREN image gate failed: {img['psnr']}")
    if not real["ok"]:
        raise SystemExit(f"SIREN image gate (--real) failed: {real['psnr']}")
    if not sdf["ok"]:
        raise SystemExit(f"SIREN SDF gate failed: mean {sdf['mean_err']}, "
                         f"p95 {sdf['p95_err']} (voxel {sdf['voxel']})")
    if "renders" not in strip or len(table["meshes"]) != 1:
        raise SystemExit("SIREN eval check failed")
    return out


def siren_stack(torch, K, FK):
    """Phases 21-24, every kernel counter set to 0 before them: no kernel
    of the port may launch on a SIREN path."""
    reset_counts()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_siren_") as tmp:
        phase(f"SIREN image fit: train_img, the four kinds at siren_img."
              f"json's recipe (batch 65,536 = 256x256, 3 x 256), "
              f"{IMG_WARM} + {IMG_TIMED} steps")
        out["img"] = siren_img(torch, tmp)
        phase(f"SIREN SDF fit: train_sdf, {', '.join(SDF_KINDS)} at "
              f"siren_sdf_1.json's recipe (65,536 + 65,536 points), "
              f"{SDF_WARM} + {SDF_TIMED} steps, final mesh n="
              f"{SDF_MESH_N}")
        out["sdf"] = siren_sdf(torch, tmp)
        phase("SIREN NeRF: train_nerf.train, lego_siren.json's recipe, 30 "
              "steps (the last 20 timed, then profiled)")
        out["nerf"] = siren_nerf(torch)
        phase("profile: SIREN image and SDF steps (siren kind), "
              "torch.profiler on")
        out["profiles"] = siren_profiles(torch, tmp)
    # The unfused sine's share of the device's busy time: the sine alone
    # (forward + backward) scaled by the elements each step passes through
    # it: 4 layers of the image MLP; the SIREN NeRF's 8 trunk layers and
    # its 128-wide direction layer over both passes' points.
    t, prof = out["profiles"]["sine_fwd_bwd_ms"], out["profiles"]
    nerf_elems = (COARSE_N + FINE_N) * (8 * SIREN_WIDTH + SIREN_WIDTH // 2)
    out["sine_share"] = {
        "img": 4 * t / prof["img"]["busy_ms"],
        "nerf": nerf_elems / (IMG_POINTS * SIREN_WIDTH) * t
        / out["nerf"]["busy_ms"]}
    print(f"  the unfused sine's share of device time: {out['sine_share']}",
          flush=True)
    torch.cuda.synchronize()
    expect_no_launches(K, FK, "phases 21-23")
    phase(f"SIREN quality: torch_validate_img {IMG_GATE_STEPS}, "
          f"torch_validate_sdf {SDF_GATE_STEPS}, torch_validate_img "
          f"{IMG_REAL_STEPS} --real; then eval.test_img and eval.test_sdf on "
          "them")
    out["gates"] = siren_gates(torch, K, FK)
    return out


def cuda_tool(name):
    """The CUDA toolkit's `name` (cuobjdump, nvdisasm), or None."""
    import shutil
    from msra_practice_project_tpu_torch.ops.kernels import build
    for path in (os.path.join(os.path.dirname(build.nvcc_path()), name),
                 shutil.which(name) or ""):
        if path and os.path.exists(path):
            return path
    return None


def sass_of(build, name, lib_path):
    """SASS of the built library of csrc/<name>.cu: cuobjdump -sass on it,
    or nvdisasm on a cubin of the same source and flags."""
    cuobjdump = cuda_tool("cuobjdump")
    if cuobjdump:
        return "cuobjdump", subprocess.run(
            [cuobjdump, "-sass", lib_path], capture_output=True, text=True,
            check=True, timeout=300).stdout
    nvdisasm = cuda_tool("nvdisasm")
    if not nvdisasm:
        raise SystemExit("neither cuobjdump nor nvdisasm found")
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, f"{name}.cubin")
        subprocess.run([build.nvcc_path(), *flags, "-cubin", "-o", cubin,
                        os.path.join(build.CSRC, f"{name}.cu")], check=True,
                       capture_output=True, timeout=600)
        return "nvdisasm", subprocess.run(
            [nvdisasm, cubin], capture_output=True, text=True, check=True,
            timeout=300).stdout


def sass_counts(sass, kernels, exact=False):
    """({kernel: [HGMMA, HMMA, HGMMA on TF32]} over the functions whose
    names contain one of `kernels`, the HMMA count over every function);
    with `exact`, an exact-sine instantiation counts as kernel + EXACT."""
    counts, cur, hmma_all = {}, None, 0
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)|\.text\.([^\s,:]+)", line)
        if m:
            name = m.group(1) or m.group(2)
            cur = next((k for k in kernels if k in name), None)
            if cur and exact and EXACT_TAG in name:
                cur += EXACT
            if cur:
                counts.setdefault(cur, [0, 0, 0])
            continue
        hmma = len(re.findall(r"\bHMMA\b", line))
        hmma_all += hmma
        if cur:
            hgmma = len(re.findall(r"\bHGMMA\b", line))
            counts[cur][0] += hgmma
            counts[cur][1] += hmma
            counts[cur][2] += hgmma if "TF32" in line else 0
    return counts, hmma_all


def check_sass(build, libs):
    """Fails unless each bf16 per-tile kernel (TC_KERNELS of the FiLM
    library, in both sine instantiations, NERF_TC_KERNELS of the NeRF one)
    has HGMMA (wgmma) and no HMMA (WMMA or mma.sync) in its SASS, K8's fp32
    kernel (TF32_KERNEL, both instantiations) and the NeRF forward's
    (NERF_TF32_KERNEL) have HGMMA, all of it on TF32 operands, and no HMMA,
    and the NeRF library has no HMMA at all.
    Returns ({kernel: (HGMMA count, HMMA count, HGMMA count on TF32)}, the
    SASS instructions of one trunk sine: sine_ops)."""
    out, ok, ops = {}, True, None
    tf32 = (TF32_KERNEL, NERF_TF32_KERNEL)
    for name, kernels in (("film_mlp", TC_KERNELS + (TF32_KERNEL,)),
                          ("nerf_mlp", NERF_TC_KERNELS + (NERF_TF32_KERNEL,))):
        tool, sass = sass_of(build, name, libs[name])
        film = name == "film_mlp"
        counts, hmma_all = sass_counts(sass, kernels, exact=film)
        want = kernels + tuple(k + EXACT for k in kernels if film)
        good = (set(counts) == set(want)
                and all(g > 0 and h == 0 for g, h, _ in counts.values())
                and all((t == g) == k.startswith(tf32)
                        for k, (g, _, t) in counts.items())
                and (film or hmma_all == 0))
        if film:
            ops = sine_ops(sass)
        ok = ok and good
        print(f"  SASS of {name} ({tool}): " + "; ".join(
            f"{k} HGMMA {g} ({t} on TF32), HMMA {h}"
            for k, (g, h, t) in counts.items())
            + f"; HMMA in the whole library {hmma_all} -> "
            f"{'ok' if good else 'FAIL'}", flush=True)
        out.update({k: tuple(v) for k, v in counts.items()})
    print(f"  SASS instructions of one trunk sine (sin_eval_kernel less "
          f"its identity): {ops}", flush=True)
    if not ok:
        raise SystemExit("the per-tile kernels are not on wgmma")
    if not (ops and all(v > 0 for v in ops.values())):
        raise SystemExit("the sine probes are missing from the SASS")
    return out, ops


SINE_FNS = {1: "poly_sin", 2: "poly_cos", 3: "exact_sin", 4: "exact_cos"}


def sine_ops(sass):
    """{poly_sin, poly_cos, exact_sin, exact_cos: SASS instructions} of one
    trunk sine or derivative: the instructions (NOPs not counted) of
    csrc/film_mlp.cu's sin_eval_kernel<FN> less those of its identity
    instantiation FN 0 (the probe's own loads, stores and index)."""
    count, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)|\.text\.([^\s,:]+)", line)
        if m:
            name = m.group(1) or m.group(2)
            fn = re.search(r"sin_eval_kernelILi(\d)E", name)
            cur = int(fn.group(1)) if fn else None
            if cur is not None:
                count[cur] = 0
            continue
        if cur is not None and re.search(r"/\*[0-9a-f]{4,}\*/\s+(?!NOP)\S",
                                         line):
            count[cur] += 1
    if set(count) != {0, *SINE_FNS}:
        return None
    return {v: count[k] - count[0] for k, v in SINE_FNS.items()}


def check_ptxas(build):
    """ptxas' resource usage (-v) of every instantiation of the FiLM kernels
    that take the trunk sine: {kernel (+ EXACT): {registers, stack_frame,
    spill_stores, spill_loads}}; fails unless each has no stack frame and
    no spills and both instantiations of each are there."""
    kernels = TC_KERNELS + (TF32_KERNEL, F32_DELTA_KERNEL)
    out = {}
    for mangled, use in build.ptxas_usage("film_mlp").items():
        k = next((k for k in kernels if re.search(rf"\d{k}I", mangled)), None)
        if k:
            out[k + (EXACT if EXACT_TAG in mangled else "")] = use
    for k, use in out.items():
        print(f"  ptxas: {k} {use}", flush=True)
    if set(out) != {k + e for k in kernels for e in ("", EXACT)} or any(
            use.get("stack_frame", 1) or use.get("spill_stores", 1)
            or use.get("spill_loads", 1) for use in out.values()):
        raise SystemExit("a FiLM kernel has a stack frame or spills, or an "
                         "instantiation is missing")
    return out


def odd_shape_layout(FK, n_img, n_pts):
    """Fails unless FILM_ODD gives the bf16 pass a chunk with an odd number
    of tiles and a CTA whose two tiles lie in two images."""
    cb = FK.chunk_images(n_img, n_pts, True)
    tiles_per_img = n_pts // FK.TC_TILE
    ctas = FK.cta_tiles(cb * tiles_per_img)
    spans = [t for t in ctas if t[1] is not None
             and t[0] // tiles_per_img != t[1] // tiles_per_img]
    print(f"  {cb} image(s) per chunk, {cb * tiles_per_img} tiles, "
          f"{len(ctas)} CTAs, last CTA {ctas[-1]}, CTAs across two images "
          f"{spans}", flush=True)
    if not (ctas[-1][1] is None and spans):
        raise SystemExit("FILM_ODD does not reach the idle warpgroup or a "
                         "CTA across images")


# Slice 15: the exact trunk sine (MSRA_TPU_FAST_SIN=0).  The device sines
# are held to a double sin/cos over |v| <= 3e3 (the trunk's 30 (g u + be)
# stays in the hundreds) and read over |v| <= 1e5.
SINE_RANGES = (3e3, 1e5)
SINE_POINTS = 1 << 24
SINE_GATE = 1e-6
EXACT_CHILD_FLAG = "--exact-sine-path"
EXACT_ITERATIONS, EXACT_TIMED = 8, 4   # phase 29's pi-GAN runs, as phase 13


@contextlib.contextmanager
def trunk_sine(fast):
    """core.nn.USE_FAST_SIN (the switch the wrappers and the plain versions
    read at each call) set to `fast` for the block."""
    from msra_practice_project_tpu_torch.core import nn
    old, nn.USE_FAST_SIN = nn.USE_FAST_SIN, fast
    try:
        yield
    finally:
        nn.USE_FAST_SIN = old


def check_device_sines(torch, FK):
    """Phase 28's first check: max |device sine - double sin| (and cos for
    the derivative) on SINE_POINTS uniform points of each |v| <= SINE_RANGES,
    the exact and the polynomial ones, and the exact ones' values that are
    not bitwise torch.sin's / torch.cos's (CUDA's sinf/cosf); fails unless
    the exact sine and cosine are within SINE_GATE of the double ones over
    the first range and bitwise torch's over both (|v| < 105,615, sinf's
    fast path, which they follow)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for lim in SINE_RANGES:
        v = (torch.rand(SINE_POINTS, device="cuda", generator=g) * 2 - 1) * lim
        vd = v.double()
        for fast in (False, True):
            for vjp in (False, True):
                got = FK.sin_eval(v, fast, vjp)
                ref = vd.cos() if vjp else vd.sin()
                key = (f"{'poly' if fast else 'exact'}_"
                       f"{'cos' if vjp else 'sin'}_{lim:g}")
                out[key] = float((got.double() - ref).abs().max())
                if not fast:
                    torch_ref = torch.cos(v) if vjp else torch.sin(v)
                    out[key + "_not_bitwise_torch"] = int(
                        (got.view(torch.int32)
                         != torch_ref.view(torch.int32)).sum())
        del v, vd
    print(f"  max |device - double| on {SINE_POINTS:,} points, and the "
          f"exact values not bitwise torch's: {json.dumps(out)}", flush=True)
    lim = f"{SINE_RANGES[0]:g}"
    if not (out[f"exact_sin_{lim}"] <= SINE_GATE
            and out[f"exact_cos_{lim}"] <= SINE_GATE
            and not any(v for k, v in out.items()
                        if k.endswith("_not_bitwise_torch"))):
        raise SystemExit(f"the exact sine is off by more than {SINE_GATE} "
                         "or not bitwise torch.sin's")
    return out


def check_film_exact(torch, FK, n_img, n_pts):
    """Phase 28 at one shape: check_film with the switch at 0 (the exact
    instantiations against the plain versions on torch.sin/torch.cos, phase
    10's gates, bitwise repeats); then, on the same inputs, K8 in fp32 and
    bf16 and K7's dfilm from the exact and the polynomial instantiations
    must differ, each call counted as exact or not.  Returns check_film's
    report."""
    with trunk_sine(False):
        report = check_film(torch, FK, n_img, n_pts)
    x, film, w, dy = film_inputs(torch, FK, n_img, n_pts)
    x, film, dy = x.cuda(), film.cuda(), dy.cuda()
    before = (FK.film_mlp_fwd.launches_exact, FK.film_mlp_bwd.launches_exact)
    diff = {}
    for bf16 in (False, True):
        wk = [t.cuda() for t in FK.kernel_weights(w, bf16)]
        a, b = (FK.film_mlp_fwd(x, film, wk, bf16, fast_sin=f)
                for f in (False, True))
        diff[f"K8 {'bf16' if bf16 else 'fp32'}"] = float((a - b).abs().max())
    a, b = (FK.film_mlp_bwd(x, film, dy, wk, True, False, fast_sin=f)[1]
            for f in (False, True))
    diff["K7 dfilm"] = float((a - b).abs().max())
    torch.cuda.synchronize()
    counted = (FK.film_mlp_fwd.launches_exact - before[0],
               FK.film_mlp_bwd.launches_exact - before[1])
    print(f"  exact vs polynomial kernels, max |diff|: {diff}; exact "
          f"launches counted (K8, K7) {counted}", flush=True)
    if not (all(d > 0 for d in diff.values()) and counted == (2, 1)):
        raise SystemExit("the exact-sine kernels did not run")
    return report


def exact_sine_path():
    """Phase 29: this script with EXACT_CHILD_FLAG in a child process under
    MSRA_TPU_FAST_SIN=0 (the switch read where the package is imported, as
    a user sets it); its output is shown and its last line, a JSON summary,
    returned.  Fails unless it exits 0."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), EXACT_CHILD_FLAG],
        cwd=ROOT, env=dict(os.environ, MSRA_TPU_FAST_SIN="0"),
        capture_output=True, text=True, timeout=600)
    print(res.stdout, end="", flush=True)
    if res.returncode != 0:
        print(res.stderr[-6000:], file=sys.stderr, flush=True)
        raise SystemExit(f"the exact-sine child exited {res.returncode}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 29: {out['seconds']:.1f} s", flush=True)
    return out


def exact_sine_child(torch, K, FK):
    """Phase 29's body (EXACT_CHILD_FLAG, MSRA_TPU_FAST_SIN=0 set by the
    caller): pi-GAN modes 1 and 2 at test.json's stage 0 through the
    exact-sine kernels only, then the SIREN image step on torch.sin with no
    kernel launched.  Prints a JSON summary as its last line."""
    from msra_practice_project_tpu_torch.core import nn
    from msra_practice_project_tpu_torch.core.config import SIREN_IMG_DEFAULTS
    from msra_practice_project_tpu_torch.train import train_img
    if nn.USE_FAST_SIN:
        raise SystemExit("MSRA_TPU_FAST_SIN=0 did not reach core.nn")
    out = {}
    for mode, f32 in ((1, 4.0), (2, 0.0)):
        phase(f"exact sine: pi-GAN mode {mode}, test.json stage 0, "
              f"{EXACT_ITERATIONS} iterations (the last {EXACT_TIMED} timed)")
        ms, launches, _, _ = pigan_path(
            torch, FK, mode, dict(iterations=[EXACT_ITERATIONS],
                                  fade_in_itrs=[0], batch_size=[64],
                                  resolution=[32], i_print=4, i_save=1000,
                                  i_image=1000),
            EXACT_TIMED, EXACT_ITERATIONS,
            {"film_mlp_fwd": 4.0, "film_mlp_fwd_f32": f32,
             "film_mlp_bwd": 1.0, "film_mlp_fwd_exact": 4.0,
             "film_mlp_bwd_exact": 1.0})
        out[f"pigan_mode{mode}"] = {"ms_per_iteration": ms,
                                    "launches": launches}
        torch.cuda.synchronize()
    steps = IMG_WARM + IMG_TIMED
    phase(f"exact sine: train_img, siren_img.json's recipe, {IMG_WARM} + "
          f"{IMG_TIMED} steps (torch.sin, no kernel)")
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_exact_") as tmp:
        cfg = siren_cfg("siren_img.json", SIREN_IMG_DEFAULTS, tmp,
                        experiment_name="img_exact", iterations=steps,
                        i_print=steps, i_save=steps, i_image=steps)
        res, ms, peak = run_siren(torch, train_img, cfg, IMG_TIMED)
    loss = res["log"]["loss"]
    print(f"  siren: {ms:.3f} ms/step, peak {peak:.3f} GiB; loss "
          f"{loss[0]:.5f} -> {loss[-1]:.5f}", flush=True)
    expect_no_launches(K, FK, "the exact-sine SIREN image fit")
    if not (len(loss) == steps and finite(loss) and loss[-1] < loss[0]):
        raise SystemExit("the exact-sine SIREN image fit failed")
    out["siren_img"] = {"ms_per_step": ms, "peak_gib": peak,
                        "loss_first": loss[0], "loss_last": loss[-1]}
    print(json.dumps(out), flush=True)
    return 0


def time_film_exact(torch, FK, ops):
    """Phase 30: time_film with the switch at 0 at both shapes, the bounds
    counting `ops` = (exact sine, cosine) SASS instructions."""
    out = {}
    with trunk_sine(False):
        for label, n_pts in (("coarse", FILM_COARSE_P), ("fine", FILM_FINE_P)):
            out[label] = t = time_film(torch, FK, FILM_B, n_pts, 10, ops=ops)
            print(f"  {label} B={FILM_B} P={n_pts}, exact sine: K8 fp32 "
                  f"{t['fwd_f32_ms']:.4f} ms (plain "
                  f"{t['fwd_f32_plain_ms']:.4f}, bound "
                  f"{t['fwd_f32_bound_ms']:.4f} "
                  f"{t['fwd_f32_bound_by']}); K8 bf16 {t['fwd_ms']:.4f} ms "
                  f"(plain {t['fwd_plain_ms']:.4f}, bound "
                  f"{t['fwd_bound_ms']:.4f} {t['fwd_bound_by']}); K7 "
                  f"{t['bwd_ms']:.4f} ms (plain {t['bwd_plain_ms']:.4f}, "
                  f"bound {t['bwd_bound_ms']:.4f} {t['bwd_bound_by']})",
                  flush=True)
            torch.cuda.synchronize()
    return out


# Slice 16: the repo-level tools on the card, and use_fused_mlp=False.  The
# tools run at cut schedules here (their defaults run by hand, PERF.md §5):
# the ablation at 300 iterations (200 of them the start-up crop), the NeRF
# soak at 1,000 iterations of 100x100 with 10 train views and a checkpoint
# every 100, the pi-GAN step profile and trunk modes at 5 timed calls a
# row, the SIREN soaks at 300 image and 300 SDF steps (a checkpoint every
# 75, the final mesh at n 128).
PLAIN_STEPS, PLAIN_STARTUP, PLAIN_TIMED = 30, 10, 20
ABLATION_STEPS, ABLATION_SIZE = 300, 64
SOAK_NERF_ARGS = ("1000", "100", "10", "--i-save", "100", "--poll", "0.5",
                  "--settle", "1")
TOOL_REPS, TOOL_WARMUP = 5, 2
SOAK_IMG_STEPS, SOAK_SDF_STEPS = 300, 300
SOAK_SDF_OVERRIDES = {"i_save": 75, "final_mesh_n": 128}
# K8 (all, fp32) and K7 launches of one call of each row that runs G, in
# mode 1: the coarse and the fine pass through K8, K7 on the fine pass's
# backward (the coarse pass is detached)
PROFILE_G_ROWS = {"G fwd (render)": (2, 2, 0), "G fwd+bwd": (2, 2, 1),
                  "D adv path (G fwd + D f/b on fake)": (2, 2, 0),
                  "full d_step": (2, 2, 0), "full g_step": (2, 2, 1)}
MODE_LAUNCHES = {"0": ((0, 0, 0), (0, 0, 0)), "1": ((2, 2, 0), (2, 2, 1)),
                 "2": ((2, 0, 0), (2, 0, 1))}
# Mode 0's G fwd+bwd (the plain trunk under autograd: FilmSine's lean
# residuals, the coarse pass without a graph) at each stage: its peak GiB
# is held to MODE0_MAX_GIB; at stage 0, where phase 34 covers modes 1 and
# 2, the tool runs mode 0 alone and with fewer calls.
MODE0_MAX_GIB = 48.0
MODE0_STAGE0_REPS, MODE0_STAGE0_WARMUP = 2, 1
# Phase 38: train_pigan.train in mode 0 across both stages of test.json
MODE0_TRAIN = dict(iterations=[3, 6], fade_in_itrs=[0, 2], i_print=3,
                   i_save=6, i_image=6)


@contextlib.contextmanager
def run_root(prefix):
    """A temporary MSRA_TPU_RUN_ROOT for the block (the tools' durable
    artifacts)."""
    with tempfile.TemporaryDirectory(prefix=prefix) as root, \
            run_root_at(root):
        yield root


def plain_nerf_path(torch, K, FK, fused_ms):
    """Phase 31: train_nerf.train on the lego recipe with
    use_fused_mlp=False: the plain models (fp32 on cuBLAS) in the step, no
    kernel of the port but the fused fp32 forward of the closing preview
    render (once per pass), the loss falling; ms/step beside the fused
    step's."""
    t0 = time.perf_counter()
    reset_counts()
    with metered_renders(K) as renders:
        ms, batch, log, ckpt, _ = run_train(
            torch, PLAIN_STEPS, PLAIN_STARTUP, PLAIN_TIMED,
            overrides={"use_fused_mlp": False})
    torch.cuda.synchronize()
    losses = log["loss"]
    first, last = (sum(losses[:5]) / 5, sum(losses[-5:]) / 5)
    print(f"  losses first/last 5 {first:.5f}/{last:.5f}, ckpt {ckpt}; "
          f"window of the last {PLAIN_TIMED} steps (CUDA events): {ms:.3f} "
          f"ms/step plain against {fused_ms:.3f} through K1/K2 (phase 3), "
          f"{batch / (ms / 1e3):,.0f} rays/s; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    expect_no_launches(K, FK, "the plain NeRF step", renders.forwards)
    if not (len(losses) == PLAIN_STEPS and finite(losses) and last < first
            and ckpt):
        raise SystemExit("the plain NeRF path check failed")
    return {"ms_per_step": ms, "rays_per_s": batch / (ms / 1e3),
            "loss_first5": first, "loss_last5": last}


class TrainMeter:
    """A function that calls train_nerf.train and records, per call, the
    run's experiment, iterations, NeRF kernel launches and the passes of
    its renders that `renders` (a RenderMeter) counted."""

    def __init__(self, K, fn, renders):
        self.K, self.fn, self.renders, self.runs = K, fn, renders, []

    def __call__(self, cfg, **kw):
        before = nerf_launches(self.K)
        forwards = self.renders.forwards
        out = self.fn(cfg, **kw)
        after = nerf_launches(self.K)
        self.runs.append((cfg["experiment_name"], cfg["iterations"],
                          {k: v - before[k] for k, v in after.items()},
                          self.renders.forwards - forwards))
        return out


def ablation_path(torch, K, FK):
    """Phase 32: tools/torch_ablation_nerf.py at ABLATION_STEPS, in a
    temporary run root: each of its 4 runs through K1/K2, the chain and the
    dW pass twice per step, the fused fp32 forward once per pass of its
    renders, a test.json per run with the JAX test_nerf's keys, the
    analysis plots (or their skip notes without matplotlib) and
    demo_param's grid."""
    from msra_practice_project_tpu_torch.train import train_nerf

    tool = load_tool("torch_ablation_nerf")
    t0 = time.perf_counter()
    with run_root("chip_smoke_ablation_") as root, \
            metered_renders(K) as renders, \
            replaced(train_nerf, "train",
                     TrainMeter(K, train_nerf.train, renders)) as meter:
        reset_counts()
        out = tool.main(ABLATION_STEPS, ABLATION_SIZE)
        torch.cuda.synchronize()
        base = os.path.join(root, "nerf_ablation")
        jsons = {}
        for exp, log_path in out["runs"].items():
            with open(os.path.join(log_path, "test.json")) as f:
                jsons[exp] = set(json.load(f))
        plots = sorted(f for f in os.listdir(base) if f.endswith(".png"))
        grid = os.path.exists(os.path.join(base, "demo_param.jpg"))
    seconds = time.perf_counter() - t0
    print(f"  runs {[(e, n) for e, n, _, _ in meter.runs]}; launches per "
          f"run {[l for _, _, l, _ in meter.runs]}; renders' passes per run "
          f"{[r for *_, r in meter.runs]}, in all {renders.forwards}; "
          f"test.json keys ok "
          f"{all(k == TEST_JSON_KEYS for k in jsons.values())}; plots "
          f"{plots or 'none (matplotlib not installed)'}; demo_param.jpg "
          f"{grid}; {seconds:.1f} s", flush=True)
    print(f"  ex PSNR {out['ex_psnr']} (monotone {out['ex_monotone']}); in "
          f"PSNR {out['in_psnr']} (monotone {out['in_monotone']}); train-view "
          f"PSNR {out['train_psnr']}", flush=True)
    has_plt = importlib.util.find_spec("matplotlib") is not None
    if not (len(meter.runs) == 4
            and all(n == ABLATION_STEPS
                    and l == nerf_want(K, ABLATION_STEPS, r)
                    for _, n, l, r in meter.runs)
            and nerf_launches(K)["nerf_mlp_fwd_tf32"] == renders.forwards
            and len(jsons) == 4
            and all(k == TEST_JSON_KEYS for k in jsons.values())
            and bool(plots) == has_plt and grid):
        raise SystemExit("the ablation path check failed")
    return {**{k: out[k] for k in ("ex_psnr", "ex_monotone", "in_psnr",
                                   "in_monotone", "train_psnr", "seconds")},
            "launches": nerf_launches(K), "phase_seconds": seconds}


def tool_child(args, prefix, timeout):
    """tools/<args[0]> with args[1:] in a child process, in a temporary run
    root; its output is shown (without the per-step and per-view lines) and
    its last line, a JSON object, returned with the seconds.  Fails unless
    it exits 0."""
    t0 = time.perf_counter()
    with run_root(prefix):
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", args[0]),
             *args[1:]], cwd=ROOT, capture_output=True, text=True,
            timeout=timeout)
    print("\n".join("  | " + line for line in res.stdout.strip().splitlines()
                    if not line.startswith(("[Train]", "[Test]"))),
          flush=True)
    if res.returncode != 0:
        print(res.stderr[-6000:], file=sys.stderr, flush=True)
        raise SystemExit(f"tools/{args[0]} exited {res.returncode}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["seconds"] = time.perf_counter() - t0
    return out


def nerf_soak_path():
    """Phase 33: tools/torch_soak_nerf.py at SOAK_NERF_ARGS in a child
    process (its trainer and eval CLIs are processes of their own, which
    load the kernels built in phase 1): rc 0, resumed from a checkpoint at
    or past the kill step, log.npy over every iteration, the sweep's
    test.json read back over every view.  The 28 dB gate holds only at the
    full schedule: printed."""
    out = tool_child(["torch_soak_nerf.py", *SOAK_NERF_ARGS],
                     "chip_smoke_soak_", 600)
    print(f"  killed at {out['kill_step']}+, resumed from "
          f"{out['resume_step']}; log {out['log_steps']} steps; PSNR "
          f"{out['summary']}; phase B {out['rays_per_s']:,.0f} rays/s; eval "
          f"{out['eval_view_s']:.3f} s a view; test.json over "
          f"{out['sweep_views']} views; {out['seconds']:.1f} s", flush=True)
    # every train view and the 8 val views scored in the sweep's test.json
    if not (out["resume_step"] >= out["kill_step"]
            and out["log_steps"] == out["iterations"]
            and out["sweep_views"] == out["n_train"] + 8):
        raise SystemExit("the NeRF soak check failed")
    return out


def pigan_tools_path(torch, FK):
    """Phases 34-35: tools/torch_profile_pigan.py at both stages of
    test.json, tools/torch_film_modes.py in mode 0 at stage 0 and in every
    mode at stage 1, in this process in the default trunk mode: every row
    finite, the rows that run G with PROFILE_G_ROWS's launches per call,
    each mode with MODE_LAUNCHES', mode 0's G fwd+bwd at each stage within
    MODE0_MAX_GIB of peak memory.  Returns the readings and their K8/K7
    launches by path."""
    profile = load_tool("torch_profile_pigan")
    modes = load_tool("torch_film_modes")
    out, by_path = {}, {}
    old = os.environ.pop("MSRA_TPU_FUSED_FILM", None)
    try:
        for batch, res in PIGAN_STAGES:
            t0 = time.perf_counter()
            reset_counts()
            r = profile.main(batch, res, n=TOOL_REPS, warmup=TOOL_WARMUP)
            torch.cuda.synchronize()
            by_path[f"profile_pigan_{batch}x{res}"] = film_launches(FK)
            r["seconds"] = time.perf_counter() - t0
            print(f"  {r['seconds']:.1f} s", flush=True)
            got = {k: (v["k8"], v["k8_f32"], v["k7"])
                   for k, v in r["launches"].items()}
            if not (finite(r["ms"].values()) and got == PROFILE_G_ROWS
                    and all(len(v) for v in r["d_kernels"].values())
                    and len(r["d_kernels"]) == 3):
                raise SystemExit(f"the pi-GAN profile at {batch}x{res} "
                                 f"failed: launches {got}")
            out[f"profile_{batch}x{res}"] = r
        for key, (batch, res), modes_here, n, warmup in (
                ("film_modes_stage0", PIGAN_STAGES[0], ("0",),
                 MODE0_STAGE0_REPS, MODE0_STAGE0_WARMUP),
                ("film_modes", PIGAN_STAGES[1], ("0", "1", "2"), TOOL_REPS,
                 TOOL_WARMUP)):
            t0 = time.perf_counter()
            reset_counts()
            r = modes.main(batch, res, modes_here, n=n, warmup=warmup)
            torch.cuda.synchronize()
            by_path[key] = film_launches(FK)
            r["seconds"] = time.perf_counter() - t0
            row0 = r["modes"]["0"]
            peak = row0["fwdbwd_peak_gib"]
            print(f"  mode 0 at {batch}x{res}: G fwd peak "
                  f"{row0['fwd_peak_gib']:.2f} GiB, G fwd+bwd peak "
                  f"{peak:.2f} GiB (limit {MODE0_MAX_GIB:g}); "
                  f"{r['seconds']:.1f} s", flush=True)
            got = {m: tuple(None if l is None else tuple(l.values())
                            for l in (v["fwd_launches"],
                                      v["fwdbwd_launches"]))
                   for m, v in r["modes"].items()}
            rows = [v[k] for v in r["modes"].values()
                    for k in ("fwd_ms", "fwdbwd_ms")]
            if not (got == {m: MODE_LAUNCHES[m] for m in modes_here}
                    and None not in rows and finite(rows)
                    and peak <= MODE0_MAX_GIB
                    and os.environ.get("MSRA_TPU_FUSED_FILM") is None):
                raise SystemExit(f"the trunk modes check at {batch}x{res} "
                                 f"failed: {got}, mode 0 peak {peak} GiB")
            out[key] = r
    finally:
        os.environ.pop("MSRA_TPU_FUSED_FILM", None)
        if old is not None:
            os.environ["MSRA_TPU_FUSED_FILM"] = old
    return out, by_path


def siren_soak_path(torch, K, FK):
    """Phase 36: tools/torch_soak_siren.py's two soaks at SOAK_IMG_STEPS and
    SOAK_SDF_STEPS (the SDF run killed past its checkpoint at 25% and
    resumed), driven from this process: both trainer CLIs exit 0, both logs
    span every step, the counters of this process (the PSNR render and the
    mesh gate) stay at 0, and the SIREN trainers, imported in a fresh
    interpreter, load no kernel module of the port (their CLIs cannot
    launch one).  The 29 dB and DEM bars hold only at the full schedule:
    printed."""
    tool = load_tool("torch_soak_siren")
    t0 = time.perf_counter()
    with run_root("chip_smoke_siren_soak_"):
        reset_counts()
        img = tool.soak_img(SOAK_IMG_STEPS)
        sdf = tool.soak_sdf(SOAK_SDF_STEPS, overrides=SOAK_SDF_OVERRIDES,
                            poll=1.0, settle=1.0)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    code = ("import sys; import msra_practice_project_tpu_torch.train."
            "train_img, msra_practice_project_tpu_torch.train.train_sdf; "
            "print([m for m in sys.modules if '.ops.kernels' in m])")
    loaded = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                            capture_output=True, text=True,
                            timeout=120).stdout.strip()
    print(f"  image: {img['log_steps']} steps, PSNR {img['psnr']:.3f} dB; "
          f"SDF: killed at {sdf['kill_step']}+, resumed from "
          f"{sdf['resume_step']}, {sdf['log_steps']} steps, mean |z - DEM| "
          f"{sdf['mean_err']:.4f}, p95 {sdf['p95_err']:.4f}; kernel modules "
          f"the SIREN trainers load: {loaded}; {seconds:.1f} s", flush=True)
    expect_no_launches(K, FK, "the SIREN soaks (this process)")
    if not (img["log_steps"] == SOAK_IMG_STEPS
            and sdf["log_steps"] == SOAK_SDF_STEPS
            and sdf["resume_step"] >= sdf["kill_step"] and loaded == "[]"):
        raise SystemExit("the SIREN soak check failed")
    return {"img": img, "sdf": sdf, "seconds": seconds}


def ckpt_grids_path(torch, FK, exp_dir):
    """Phase 37: tools/torch_pigan_ckpt_grids.py on phase 18's gate
    experiment: one row per checkpoint, and K8 in fp32 only (the coarse
    and the fine pass at each checkpoint)."""
    from PIL import Image

    tool = load_tool("torch_pigan_ckpt_grids")
    old = os.environ.pop("MSRA_TPU_FUSED_FILM", None)
    t0 = time.perf_counter()
    try:
        reset_counts()
        out = tool.main(exp_dir)
        torch.cuda.synchronize()
    finally:
        if old is not None:
            os.environ["MSRA_TPU_FUSED_FILM"] = old
    counts = film_launches(FK)
    if out["out"] is None:
        raise SystemExit(f"no checkpoints under {exp_dir}")
    with Image.open(out["out"]) as im:
        size = im.size
    out["seconds"] = time.perf_counter() - t0
    print(f"  checkpoints {out['steps']}, grid {size}, launches {counts}, "
          f"{out['seconds']:.1f} s", flush=True)
    n = len(out["steps"])
    if size != (8 * out["resolution"], n * out["resolution"]) or n < 2:
        raise SystemExit("ckpt_evolution.png does not hold one row per "
                         "checkpoint")
    _expect_k8_only(counts, "the checkpoint grids", 2 * n)
    return out, counts


def pigan_mode0_path(torch, K, FK):
    """Phase 38: train_pigan.train on test.json in mode 0 (the plain trunk,
    MSRA_TPU_FUSED_FILM=0) across both stages, MODE0_TRAIN's schedule:
    every loss finite, no kernel of the port launched, the last
    iteration's checkpoint and demo grid written; its peak memory
    printed."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    batch, res = PIGAN_STAGES[1]
    last = MODE0_TRAIN["iterations"][-1]
    ms, _, _, _ = pigan_path(
        torch, FK, 0, MODE0_TRAIN, last - MODE0_TRAIN["iterations"][0] - 1,
        last - 1, {"film_mlp_fwd": 0.0, "film_mlp_fwd_f32": 0.0,
                   "film_mlp_bwd": 0.0, "film_mlp_fwd_exact": 0.0,
                   "film_mlp_bwd_exact": 0.0}, files=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_no_launches(K, FK, "pi-GAN mode 0 training")
    seconds = time.perf_counter() - t0
    print(f"  mode 0 at stage 1 ({batch} at {res}x{res}): {ms:.3f} "
          f"ms/iteration; peak {peak:.2f} GiB; {seconds:.1f} s", flush=True)
    return {"ms_per_iter_stage1": ms, "peak_gib": peak, "seconds": seconds}


def tools_slice(torch, K, FK, summary, kernels, exp_dir):
    """Phases 31-38; their readings go into `summary` and their launches
    into the K1, K2, K7 and K8 entries of `kernels`."""
    phase(f"plain NeRF step: train_nerf.train, lego recipe, "
          f"use_fused_mlp=False, {PLAIN_STEPS} iterations")
    summary["nerf_plain"] = plain_nerf_path(torch, K, FK,
                                            summary["nerf_step_ms"])
    phase(f"NeRF ablation: tools/torch_ablation_nerf.py {ABLATION_STEPS} "
          f"{ABLATION_SIZE} (cut from 2000)")
    summary["ablation"] = abl = ablation_path(torch, K, FK)
    phase(f"NeRF soak: tools/torch_soak_nerf.py {' '.join(SOAK_NERF_ARGS)} "
          "(cut from 200000 400 50), a child process")
    summary["nerf_soak"] = nerf_soak_path()
    phase("pi-GAN step profile (tools/torch_profile_pigan.py, both stages) "
          "and trunk modes (tools/torch_film_modes.py: mode 0 at stage 0, "
          "every mode at stage 1)")
    summary["pigan_tools"], film_paths = pigan_tools_path(torch, FK)
    phase(f"SIREN soaks: tools/torch_soak_siren.py, image {SOAK_IMG_STEPS} "
          f"and SDF {SOAK_SDF_STEPS} steps (cut from 10000 and 100000)")
    summary["siren_soak"] = siren_soak_path(torch, K, FK)
    phase("pi-GAN checkpoint grids: tools/torch_pigan_ckpt_grids.py on the "
          "gate's experiment")
    summary["ckpt_grids"], film_paths["ckpt_grids"] = ckpt_grids_path(
        torch, FK, exp_dir)
    phase(f"pi-GAN mode 0 (the plain trunk): train_pigan.train, test.json, "
          f"iterations {MODE0_TRAIN['iterations']}, fade-in "
          f"{MODE0_TRAIN['fade_in_itrs']}")
    summary["pigan_mode0_train"] = pigan_mode0_path(torch, K, FK)

    by_name = {k["name"]: k for k in kernels}
    for name in ("nerf_mlp_fwd_save", "nerf_mlp_bwd_saved",
                 "nerf_mlp_deltas", "dw_splitk"):
        entry = by_name[name]
        entry.setdefault("launches_by_path", {}).update(
            ablation=abl["launches"][name])
        entry["launched_by"] += ("; tools/torch_ablation_nerf.py; "
                                 "tools/torch_soak_nerf.py (its child "
                                 "processes, not counted)")
    k7, k8 = by_name["film_mlp_bwd"], by_name["film_mlp_fwd"]
    for path, c in film_paths.items():
        if c["film_mlp_bwd"]:
            k7["launches_by_path"][path] = c["film_mlp_bwd"]
        if c["film_mlp_fwd_f32"]:
            k8["f32"]["launches_by_path"][path] = c["film_mlp_fwd_f32"]
        if c["film_mlp_fwd"] > c["film_mlp_fwd_f32"]:
            k8.setdefault("launches_by_path", {})[path] = (
                c["film_mlp_fwd"] - c["film_mlp_fwd_f32"])
    k7["launched_by"] += ("; tools/torch_profile_pigan.py; "
                          "tools/torch_film_modes.py")
    k8["launched_by"] += "; tools/torch_film_modes.py (mode 2)"
    k8["f32"]["launched_by"] += ("; tools/torch_profile_pigan.py; "
                                 "tools/torch_film_modes.py; "
                                 "tools/torch_pigan_ckpt_grids.py")



def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from msra_practice_project_tpu_torch.ops.kernels import build
        from msra_practice_project_tpu_torch.ops.kernels import dw_splitk as DW
        from msra_practice_project_tpu_torch.ops.kernels import film_mlp as FK
        from msra_practice_project_tpu_torch.ops.kernels import nerf_mlp as K
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    from msra_practice_project_tpu_torch import set_plain_precision
    set_plain_precision()
    if sys.argv[1:] == [EXACT_CHILD_FLAG]:
        return exact_sine_child(torch, K, FK)

    t_start = time.perf_counter()
    phase("device and build")
    smi = nvidia_smi_line()
    print(f"  {smi}", flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    libs = build.load_all(["nerf_mlp", "film_mlp"])
    print(f"  built {', '.join(os.path.basename(l._name) for l in libs)} "
          f"({time.perf_counter() - t0:.1f} s, in parallel)", flush=True)
    sass, sin_ops = check_sass(build, {"nerf_mlp": libs[0]._name,
                                       "film_mlp": libs[1]._name})
    ptxas = check_ptxas(build)
    torch.cuda.synchronize()
    summary, kernels = {"ptxas_film": ptxas, "sine_sass_ops": sin_ops}, []

    phase("split-K dW pass (tile_mm.cuh) vs its plain version: one CTA, "
          "then K2's and K7's task tables")
    dw_err = check_dw(torch, DW)

    errs = {}
    for n in (COARSE_N, FINE_N):
        phase(f"K1/K2 vs plain versions at N={n}")
        for name, err in check_kernels(torch, K, n).items():
            errs[name] = max(err, errs.get(name, 0.0))
        torch.cuda.synchronize()

    phase("NeRF main path: train_nerf.train, lego recipe, 30 iterations")
    launches, step_ms, rays = main_path(torch, K, 30, 10, 20)
    torch.cuda.synchronize()

    phase("profile: the same train run, torch.profiler on for its window")
    prof_ms, busy, idle, named = profiled_window(torch, 30, 10, 20)
    torch.cuda.synchronize()

    phase(f"NeRF quality: tools/torch_validate_nerf.py, easy scene, "
          f"{QUALITY_STEPS} steps at {QUALITY_SIZE}x{QUALITY_SIZE} (K1/K2), "
          f"gate test PSNR > 28 dB; then eval.test_nerf on it")
    summary["nerf_quality"] = quality_path(torch, K)
    torch.cuda.synchronize()

    phase("K1/K2 and K2's delta chain timings (bf16, CUDA events, median)")
    k12 = ("nerf_mlp_fwd_save", "nerf_mlp_bwd_saved", "nerf_mlp_deltas")
    times = {}
    for label, n in (("coarse", COARSE_N), ("fine", FINE_N)):
        times[label] = t = time_kernels(torch, K, k12, n, 25)
        print(f"  {label} N={n}: " + "; ".join(
            f"{name} {t[name]['ms']:.4f} ms (plain {t[name]['plain_ms']:.4f},"
            f" bound {t[name]['bound_ms']:.4f} {t[name]['bound_by']})"
            for name in k12), flush=True)
        torch.cuda.synchronize()
    src = "msra_practice_project_tpu_torch/ops/kernels/csrc/nerf_mlp.cu"
    pallas = "msra_practice_project_tpu/ops/pallas/nerf_mlp.py"
    for name, line, tc in (
            ("nerf_mlp_fwd_save", 336, NERF_TC_KERNELS[0]),
            ("nerf_mlp_bwd_saved", 353, None),
            ("nerf_mlp_deltas", 353, NERF_TC_KERNELS[1])):
        entry = kernel_entry(
            name, src, f"{pallas}:{line}", launches[name], errs[name],
            times["coarse"][name], times["fine"][name],
            f"N={COARSE_N} (coarse pass)", f"N={FINE_N}",
            "train_nerf, lego recipe" + (" (inside K2)"
                                         if name == "nerf_mlp_deltas" else ""))
        if tc:
            entry["sass"] = {tc: {"HGMMA": sass[tc][0], "HMMA": sass[tc][1]}}
            entry["profiled"] = {tc: named[tc]}
        kernels.append(entry)
    summary.update(nerf_step_ms=step_ms, nerf_rays_per_s=rays,
                   nerf_profiled_step_ms=prof_ms, nerf_device_busy_ms=busy,
                   nerf_profiled_idle_share=idle,
                   **{f"nerf_profiled_{k}_ms_per_step": v["ms_per_iteration"]
                      for k, v in named.items()})

    # the two passes' shapes and the roofline path's own (in bf16 K5 runs
    # that one in two chunks)
    tool = load_tool("torch_roofline_nerf")
    for n in (COARSE_N, FINE_N, ROOFLINE_BATCH * tool.PTS_PER_RAY):
        phase(f"K3/K6 vs plain version at N={n}")
        for name, err in check_fwd(torch, K, n).items():
            errs[name] = max(err, errs.get(name, 0.0))
        phase(f"K5/K4 vs plain versions at N={n} (K5 in "
              f"{-(-n // K.chunk_rows(n, True))} chunk(s) in bf16, "
              f"{-(-n // K.chunk_rows(n, False))} in fp32)")
        for name, err in check_bwd(torch, K, n).items():
            errs[name] = max(err, errs.get(name, 0.0))
        torch.cuda.synchronize()

    phase(f"K3-K6 path: tools/torch_roofline_nerf.py, batch {ROOFLINE_BATCH},"
          " main and fwdwall modes")
    rl_launches, rl_main, rl_wall = roofline_path(torch, K, tool)
    summary.update({f"roofline_{k}": v for k, v in rl_main.items()
                    if k.endswith(("_ms", "_per_s", "_tflops",
                                   "_ms_per_step"))})
    summary.update({f"fwdwall_{k}": v for k, v in rl_wall.items()
                    if k.endswith(("_ms", "_tflops"))})

    phase("K3/K6/K5/K4 timings (bf16, CUDA events, median)")
    print(f"  {nvidia_smi_line()}", flush=True)
    k3456 = ("nerf_mlp_fwd", "nerf_mlp_fwd_pipelined", "nerf_mlp_bwd",
             "nerf_mlp_dx")
    roofline_n = ROOFLINE_BATCH * tool.PTS_PER_RAY
    for label, n, names in (("coarse", COARSE_N, k3456),
                            ("fine", FINE_N, k3456),
                            ("roofline", roofline_n, ("nerf_mlp_dx",))):
        times[label] = t = time_kernels(torch, K, names, n, 25)
        print(f"  {label} N={n}: " + "; ".join(
            f"{name} {t[name]['ms']:.4f} ms (plain {t[name]['plain_ms']:.4f},"
            f" bound {t[name]['bound_ms']:.4f} {t[name]['bound_by']})"
            for name in names), flush=True)
        k4 = t["nerf_mlp_dx"]
        print(f"  K4 at N={n}: {k4['ms']:.4f} ms on K5's copy, "
              f"{k4['k2_workspace_ms']:.4f} on K2's workspace, "
              f"{k4['bound_ms'] / k4['ms']:.3f} of its bound; cuBLAS "
              f"products alone {k4['library_ms']:.4f} ms", flush=True)
        torch.cuda.synchronize()
    for name, line in (("nerf_mlp_fwd", 279), ("nerf_mlp_fwd_pipelined", 294),
                       ("nerf_mlp_bwd", 500), ("nerf_mlp_dx", 605)):
        entry = kernel_entry(
            name, src, f"{pallas}:{line}", rl_launches[name], errs[name],
            times["coarse"][name], times["fine"][name], f"N={COARSE_N}",
            f"N={FINE_N}", "tools/torch_roofline_nerf.py, batch 1024, "
            "main + fwdwall")
        if name == "nerf_mlp_dx":
            entry["sass"] = {NERF_TC_KERNELS[2]: {
                "HGMMA": sass[NERF_TC_KERNELS[2]][0],
                "HMMA": sass[NERF_TC_KERNELS[2]][1]}}
            entry["roofline"] = {"shape": f"N={roofline_n}",
                                 **times["roofline"][name]}
        kernels.append(entry)

    phase(f"the fused fp32 forward ({NERF_TF32_KERNEL}, 3xTF32) vs its "
          f"plain version at a view tile's passes (N={VIEW_TILE_N[0]:,}, "
          f"{VIEW_TILE_N[1]:,}), timed; render_image through it")
    tf32 = check_nerf_tf32(torch, K, build)
    torch.cuda.synchronize()
    summary["nerf_tf32_render"] = tf32.pop("render")
    summary["ptxas_nerf_tf32"] = tf32.pop("ptxas")
    tc, fc = (dict(tf32[n]) for n in VIEW_TILE_N)
    err = max(max(r["err_vs_plain_version"], r["err_vs_fp32_forward"])
              for r in (tc, fc))
    entry = kernel_entry(
        "nerf_mlp_fwd_tf32", src, "none (the port's route for the forwards "
        "autograd does not record: view renders)",
        summary["nerf_tf32_render"]["launches"], err, tc, fc,
        f"N={VIEW_TILE_N[0]} (a view tile's coarse pass)",
        f"N={VIEW_TILE_N[1]}", "NeRFModel.forward without autograd "
        "(render_image, 200x200)")
    entry["sass"] = {NERF_TF32_KERNEL: {
        "HGMMA": sass[NERF_TF32_KERNEL][0],
        "HGMMA_TF32": sass[NERF_TF32_KERNEL][2],
        "HMMA": sass[NERF_TF32_KERNEL][1]}}
    kernels.append(entry)

    film_errs = {}
    for n_img, n_pts in ((FILM_B, FILM_COARSE_P), (FILM_B, FILM_FINE_P),
                         FILM_ODD):
        phase(f"K7/K8 vs plain versions at B={n_img}, P={n_pts}")
        if (n_img, n_pts) == FILM_ODD:
            odd_shape_layout(FK, n_img, n_pts)
        for name, err in check_film(torch, FK, n_img, n_pts).items():
            film_errs[name] = max(err, film_errs.get(name, 0.0))
        torch.cuda.synchronize()

    worst = 0.0
    for batch, res in PIGAN_STAGES:
        phase(f"mode 1's trunk (K8 in fp32) on render_film's points vs the "
              f"plain trunk: {batch} images of {res}x{res}")
        worst = max(worst, check_mode1_trunk(torch, FK, batch, res))
        torch.cuda.synchronize()
    summary["pigan_mode1_trunk_err_over_max"] = worst

    phase("pi-GAN main path: train_pigan.train, test.json, mode 1 "
          "(hybrid: K8 in fp32, K7), iterations [20, 30], fade-in [0, 5]")
    ms1, launches1, _, _ = pigan_path(
        torch, FK, 1, dict(iterations=[20, 30], fade_in_itrs=[0, 5],
                           i_print=10, i_save=30, i_image=30),
        10, 20, {"film_mlp_fwd": 4.0, "film_mlp_fwd_f32": 4.0,
                 "film_mlp_bwd": 1.0, "film_mlp_fwd_exact": 0.0,
                 "film_mlp_bwd_exact": 0.0}, files=True)
    torch.cuda.synchronize()
    phase("pi-GAN mode 2 (K8 forward in bf16): stage 0, 8 iterations")
    ms2, launches2, _, _ = pigan_path(
        torch, FK, 2, dict(iterations=[8], fade_in_itrs=[0],
                           batch_size=[64], resolution=[32], i_print=4,
                           i_save=1000, i_image=1000),
        4, 8, {"film_mlp_fwd": 4.0, "film_mlp_fwd_f32": 0.0,
               "film_mlp_bwd": 1.0, "film_mlp_fwd_exact": 0.0,
               "film_mlp_bwd_exact": 0.0})
    torch.cuda.synchronize()
    print(f"  ms/iteration at stage 0: mode 1 {ms1:.3f}, mode 2 "
          f"{ms2:.3f}", flush=True)
    summary.update(pigan_mode1_ms_per_iter=ms1,
                   pigan_mode1_images_per_s=64 / (ms1 / 1e3),
                   pigan_mode2_ms_per_iter=ms2,
                   pigan_mode2_images_per_s=64 / (ms2 / 1e3))

    from torch.profiler import ProfilerActivity, profile
    delta, k8_prof = {}, {}
    for mode in (1, 2):
        phase(f"profile: pi-GAN mode {mode}, stage 0, 6 iterations, "
              "torch.profiler on for the last 3")
        prof = profile(activities=[ProfilerActivity.CUDA])
        ms = run_pigan(torch, FK, mode, dict(
            iterations=[6], fade_in_itrs=[0], batch_size=[64],
            resolution=[32], i_print=3, i_save=1000, i_image=1000), 3, 6,
            window=prof)[0]
        busy, idle, by_name = profile_report(prof, 3, ms, "iteration")
        summary.update({f"pigan_mode{mode}_profiled_ms_per_iter": ms,
                        f"pigan_mode{mode}_device_busy_ms": busy,
                        f"pigan_mode{mode}_profiled_idle_share": idle})
        delta[f"mode{mode}"] = d = kernel_by_name(by_name, TC_KERNELS[0], 3)
        print(f"  {TC_KERNELS[0]}: {d['ms_per_iteration']:.3f} ms/iteration "
              f"in {d['launches_per_iteration']:g} launches, "
              f"{d['ms_per_launch']:.4f} ms per launch", flush=True)
        if not d["launches_per_iteration"]:
            raise SystemExit(f"{TC_KERNELS[0]} not seen in the profile")
        k8 = TF32_KERNEL if mode == 1 else TC_KERNELS[1]
        k8_prof[f"mode{mode}"] = d = kernel_by_name(by_name, k8, 3)
        print(f"  {k8}: {d['ms_per_iteration']:.3f} ms/iteration in "
              f"{d['launches_per_iteration']:g} launches", flush=True)
        if d["launches_per_iteration"] != 4:
            raise SystemExit(f"{k8} not launched 4 times per iteration in "
                             f"the mode {mode} profile")
        torch.cuda.synchronize()

    phase("K7/K8 timings (bf16, CUDA events, median)")
    ftimes = {}
    for label, n_pts in (("coarse", FILM_COARSE_P),
                         ("fine", FILM_FINE_P)):
        ftimes[label] = t = time_film(torch, FK, FILM_B, n_pts, 10)
        print(f"  {label} B={FILM_B} P={n_pts}: K8 {t['fwd_ms']:.4f} ms "
              f"(plain {t['fwd_plain_ms']:.4f}, bound "
              f"{t['fwd_bound_ms']:.4f} {t['fwd_bound_by']}; fp32 "
              f"{t['fwd_f32_ms']:.4f}, plain fp32 "
              f"{t['fwd_f32_plain_ms']:.4f}, bound (3xTF32) "
              f"{t['fwd_f32_bound_ms']:.4f} {t['fwd_f32_bound_by']}, the "
              f"same MACs as FMA at the CUDA cores' peak (arithmetic) "
              f"{t['fwd_f32_fma_ms']:.4f}); K7 "
              f"{t['bwd_ms']:.4f} ms (plain {t['bwd_plain_ms']:.4f}, "
              f"bound {t['bwd_bound_ms']:.4f} {t['bwd_bound_by']})",
              flush=True)
        torch.cuda.synchronize()
    src = "msra_practice_project_tpu_torch/ops/kernels/csrc/film_mlp.cu"
    for name, pre, replaces, n_launches, path in (
            ("film_mlp_bwd", "bwd",
             "msra_practice_project_tpu/ops/pallas/film_mlp.py:206",
             launches1["film_mlp_bwd"], "train_pigan, test.json, mode 1"),
            ("film_mlp_fwd", "fwd",
             "msra_practice_project_tpu/ops/pallas/film_mlp.py:160",
             launches2["film_mlp_fwd"], "train_pigan, test.json, mode 2")):
        entry = kernel_entry(
            name, src, replaces, n_launches, film_errs[name],
            by_kernel(ftimes["coarse"], pre), by_kernel(ftimes["fine"], pre),
            f"B={FILM_B} P={FILM_COARSE_P} (coarse pass)",
            f"B={FILM_B} P={FILM_FINE_P}", path)
        tc = TC_KERNELS[0] if pre == "bwd" else TC_KERNELS[1]
        entry["sass"] = {tc: {"HGMMA": sass[tc][0], "HMMA": sass[tc][1]}}
        if pre == "bwd":
            entry["delta_kernel"] = {"name": TC_KERNELS[0],
                                     "profiled": delta}
        else:
            entry["profiled"] = {TC_KERNELS[1]: k8_prof["mode2"]}
            f32 = [{k: ftimes[label][f"fwd_f32_{k}"]
                    for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                   for label in ("coarse", "fine")]
            entry["f32"] = {
                "name": f"{name} (fp32)", "kernel": TF32_KERNEL,
                "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches1["film_mlp_fwd_f32"],
                "max_abs_err": film_errs["film_mlp_fwd_f32"],
                "library_ms": None, **f32[0],
                "shape": f"B={FILM_B} P={FILM_COARSE_P} (coarse pass)",
                "launched_by": "train_pigan, test.json, mode 1",
                "fine": {"shape": f"B={FILM_B} P={FILM_FINE_P}", **f32[1]},
                "sass": {TF32_KERNEL: {"HGMMA": sass[TF32_KERNEL][0],
                                       "HGMMA_TF32": sass[TF32_KERNEL][2],
                                       "HMMA": sass[TF32_KERNEL][1]}},
                "profiled": {TF32_KERNEL: k8_prof["mode1"]}}
        kernels.append(entry)

    phase("split-K dW pass timings (bf16, CUDA events, median)")
    dtimes = {}
    for table, n in DW_SHAPES:
        dtimes[(table, n)] = t = time_dw(torch, DW, table, n, 25)
        print(f"  {table} tasks N={n}: {t['ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f}, cuBLAS per task {t['library_ms']:.4f}, "
              f"bound {t['bound_ms']:.4f} {t['bound_by']})", flush=True)
        torch.cuda.synchronize()
    entry = kernel_entry(
        "dw_splitk",
        "msra_practice_project_tpu_torch/ops/kernels/csrc/tile_mm.cuh",
        "msra_practice_project_tpu/ops/pallas/nerf_mlp.py:528",
        launches["dw_splitk"], dw_err, dtimes[("nerf", COARSE_N)],
        dtimes[("nerf", FINE_N)], f"K2's tasks, N={COARSE_N}",
        f"N={FINE_N}", "train_nerf, lego recipe (inside K2)")
    entry["film"] = {"shape": f"K7's tasks, B={FILM_B} P={FILM_COARSE_P}",
                     **dtimes[("film", FILM_ROWS)]}
    entry["profiled"] = {"dw_splitk_tc_kernel": named["dw_splitk_tc_kernel"]}
    entry["launches_by_path"] = {
        "nerf_step": launches["dw_splitk"],
        "roofline": rl_launches["dw_splitk"],
        "pigan_mode1": launches1["dw_splitk"],
        "pigan_mode2": launches2["dw_splitk"]}
    kernels.append(entry)

    # the pi-GAN gate's run root lives until phase 37 reads its checkpoints
    pigan_runs = tempfile.TemporaryDirectory(prefix="chip_smoke_runs_")
    exp_dir = pigan_rest(torch, FK, summary, kernels, pigan_runs.name)
    summary["siren"] = siren_stack(torch, K, FK)

    phase("data parallelism (2 gloo ranks on the card, a one-rank NCCL "
          "group), exact resume, profile_steps and debug_nans: "
          "tools/torch_dp_check.py (phases 25-27)")
    summary["operations"] = dp_check()

    exact_errs, exact = {}, {}
    phase(f"exact sine: the device sines vs a double sin/cos (|v| <= "
          f"{SINE_RANGES[0]:g}: gate {SINE_GATE:g})")
    exact["device_sines"] = check_device_sines(torch, FK)
    for n_img, n_pts in ((FILM_B, FILM_COARSE_P), (FILM_B, FILM_FINE_P),
                         FILM_ODD):
        phase(f"exact sine: K7/K8 vs plain versions at B={n_img}, "
              f"P={n_pts} (MSRA_TPU_FAST_SIN=0)")
        for name, err in check_film_exact(torch, FK, n_img, n_pts).items():
            exact_errs[name] = max(err, exact_errs.get(name, 0.0))
        torch.cuda.synchronize()
    phase("exact sine: pi-GAN modes 1 and 2 and the SIREN image step in a "
          "child process under MSRA_TPU_FAST_SIN=0")
    exact["path"] = path = exact_sine_path()
    phase("exact sine: K7/K8 timings (CUDA events, median)")
    print(f"  {nvidia_smi_line()}", flush=True)
    ops = (sin_ops["exact_sin"], sin_ops["exact_cos"])
    etimes = time_film_exact(torch, FK, ops)
    exact["times"] = etimes
    summary["exact_sine"] = exact
    m1, m2 = path["pigan_mode1"]["launches"], path["pigan_mode2"]["launches"]
    pallas = "msra_practice_project_tpu/ops/pallas/film_mlp.py"
    for name, pre, tc, mode, by_path in (
            ("film_mlp_fwd_f32_exact", "fwd_f32", TF32_KERNEL, 1,
             {"pigan_mode1_exact": m1["film_mlp_fwd_exact"]}),
            ("film_mlp_fwd_exact", "fwd", TC_KERNELS[1], 2,
             {"pigan_mode2_exact": m2["film_mlp_fwd_exact"]}),
            ("film_mlp_bwd_exact", "bwd", TC_KERNELS[0], 1,
             {"pigan_mode1_exact": m1["film_mlp_bwd_exact"],
              "pigan_mode2_exact": m2["film_mlp_bwd_exact"]})):
        entry = kernel_entry(
            name, "msra_practice_project_tpu_torch/ops/kernels/csrc/"
            "film_mlp.cu", f"{pallas}:{206 if pre == 'bwd' else 160}",
            by_path[f"pigan_mode{mode}_exact"],
            exact_errs[name.removesuffix("_exact")],
            by_kernel(etimes["coarse"], pre), by_kernel(etimes["fine"], pre),
            f"B={FILM_B} P={FILM_COARSE_P} (coarse pass)",
            f"B={FILM_B} P={FILM_FINE_P}",
            f"train_pigan, test.json, MSRA_TPU_FAST_SIN=0, mode {mode}")
        g, h, t = sass[tc + EXACT]
        entry.update(kernel=tc + "<true>", launches_by_path=by_path,
                     sine_sass_ops=dict(zip(("sin", "cos"), ops)),
                     sass={tc + EXACT: {"HGMMA": g, "HMMA": h,
                                        "HGMMA_TF32": t}},
                     ptxas=ptxas[tc + EXACT])
        kernels.append(entry)

    tools_slice(torch, K, FK, summary, kernels, exp_dir)
    pigan_runs.cleanup()
    summary["seconds"] = time.perf_counter() - t_start
    print(f"  chip_smoke: {summary['seconds']:.1f} s", flush=True)

    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dp_check() -> dict:
    """Phases 25-27: tools/torch_dp_check.py in a child process (its ranks
    are processes of their own); its output is shown, and its last line, a
    JSON summary, is returned.  Fails unless it exits 0."""
    out = tool_child(["torch_dp_check.py"], "chip_smoke_dp_", 700)
    print(f"  phases 25-27: {out['seconds']:.1f} s", flush=True)
    return out


def by_kernel(t, pre):
    """One kernel's {ms, plain_ms, bound_ms, bound_by} from a timing dict
    keyed "<pre>_ms", "<pre>_plain_ms", ..."""
    return {k: t[f"{pre}_{k}"] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by")}


def kernel_entry(name, src, replaces, launches, err, coarse, fine, shape,
                 fine_shape, path):
    """One kernel's entry of the `kernels` line: the coarse-pass shape's
    numbers at the top level, the fine pass's under "fine"."""
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "library_ms": None,
        **coarse, "shape": shape, "launched_by": path,
        "fine": {"shape": fine_shape, **fine},
    }


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (msra_practice_project_tpu_torch) on
one NVIDIA GPU.

Phases; any failure exits non-zero:
  1. the card's name and power limit; build the CUDA kernels from the sources
     in this checkout, one nvcc per source, all started together; the
     built libraries' SASS (cuobjdump, or nvdisasm on a cubin) must hold
     HGMMA and no HMMA in the bf16 per-tile kernels of K7 and K8
     (film_mlp) and of K1/K3/K6 and K2's delta chain (nerf_mlp), HGMMA on
     TF32 operands and no HMMA in K8's fp32 kernel (film_fwd_tf32_kernel),
     and no HMMA anywhere in the NeRF library;
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
     pass must be launched twice per step.  Its last 20 steps are one timed
     window (CUDA events): ms/step and rays/s;
  4. the same run again with torch.profiler (device activity only) on for
     its timed window: the device's busy time, the window's wall time and
     idle share, and the device time by kernel, all from that one window
     (the profiler's own host cost shows as the gap to phase 3's ms/step),
     the bf16 per-tile kernels (K1's, K2's delta chain) and the split-K pass
     by name in ms per step;
  4b. the NeRF quality gate: tools/torch_validate_nerf.py's main (the easy
     analytic scene rendered at 64x64 and trained for 3000 steps, the
     recipe of BASELINE.md's 37.5 dB) in this process; K1 and K2, K2's
     delta chain and its split-K pass must be launched twice per step, and
     the held-out test views' PSNR (plain models) must exceed 28 dB; then
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
     activations and deltas and end to end; K5's dW/db must be bitwise
     equal to K1 -> K2's, dx from K5 + K4 to dx from K2 + K4, two K5
     launches to each other and need_dx=False to need_dx=True;
  8. their path, tools/torch_roofline_nerf.py at batch 1024 in both modes
     (run in this process): the step's breakdown by stage, fused_nerf_apply
     at its defaults (forward K3 1, forward + backward K3 1, K5 1, K4 1 per
     call) and fwdwall (K6 launched);
  9. K3, K6, K5 and K4 per launch at both shapes beside the plain version
     and the least time the card could take;
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
The split-K pass's launches are counted over every path: 2 per NeRF step
(K2's), 1 per K5 chunk, 1 per K7 chunk; the delta chain's: 2 per NeRF step
(K2's), 1 per bf16 K5 chunk.
The second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import importlib.util
import json
import os
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
    against its plain version on K5's deltas with K7's dx gates (fp32 1e-3
    of max|ref|, bf16 5e-2 relative Frobenius).  End to end, against the
    plain K5 (its own recompute) and plain K4: relative Frobenius per
    tensor, 5e-3 in fp32 (a relu mask that flips between two fp32 forwards
    moves one point's deltas; bf16 arithmetic reads ~1e-2) and 5e-2 in
    bf16.  Bitwise: K5's dW/db = K1 -> K2's,
    dx from K5 + K4 = dx from K2 + K4, two K5 launches, need_dx=False's
    dW/db = need_dx=True's.  Returns the bf16 mode's max |kernel - plain|
    per kernel (on the same inputs)."""
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
        g_chain = K.nerf_mlp_bwd_saved_plain(wk, dy, acts, bf16)[0]
        del acts
        g5, dh5 = K.nerf_mlp_bwd(x, wk, dy, bf16, True)
        g5b, dh5b = K.nerf_mlp_bwd(x, wk, dy, bf16, True)
        g5n, dh5n = K.nerf_mlp_bwd(x, wk, dy, bf16, False)
        dx5 = K.nerf_mlp_dx(x, wk, dh5, bf16)
        g_p, dh_p = K.nerf_mlp_bwd_plain(x, wk, dy, bf16, True)
        dx_k4 = K.nerf_mlp_dx_plain(x, wk, dh5, bf16)
        dx_p = K.nerf_mlp_dx_plain(x, wk, dh_p, bf16)
        torch.cuda.synchronize()
        bits = {"K5 == K1->K2": same(g5, g2),
                "dx K5+K4 == K2+K4": torch.equal(dx5, dx2),
                "K5 repeat": same(g5, g5b) and same(dh5, dh5b),
                "need_dx=False == True": dh5n is None and same(g5n, g5)}
        worst, key, max_abs = grad_worst(K, g5, g_chain, bf16)
        e2e, e2e_key, _ = grad_worst(K, g5, g_p, True)
        k4_err = float((dx5 - dx_k4).abs().max())
        k4 = (rel_frob(dx5, dx_k4) if bf16
              else k4_err / max(float(dx_k4.abs().max()), 1e-30))
        dx_e2e = rel_frob(dx5, dx_p)
        e2e_gate = 5e-2 if bf16 else 5e-3
        ok = (all(bits.values()) and worst <= (5e-2 if bf16 else 1e-4)
              and k4 <= (5e-2 if bf16 else 1e-3) and e2e <= e2e_gate
              and dx_e2e <= e2e_gate)
        print(f"  K5/K4 bf16={bf16}: K5 vs plain chain on its activations "
              f"{'rel frob' if bf16 else 'err/max'} {worst:.3e} at {key} "
              f"(max|err| {max_abs:.3e}); K4 vs plain on its deltas "
              f"{'rel frob' if bf16 else 'err/max'} {k4:.3e} (max|err| "
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
        del g2, dh2, dx2, g_chain, g5, dh5, g5b, dh5b, g5n, dx5, g_p, dh_p
        del dx_k4, dx_p
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
# K1's (K3's, K6's) and K2's delta chain's (csrc/nerf_mlp.cu)
NERF_TC_KERNELS = ("nerf_fwd_tc_kernel", "nerf_bwd_delta_tc_kernel")


def film_inputs(torch, FK, n_img, n_pts, seed=0):
    """The G step's trunk inputs at stage 0: points on rays of random poses
    from the pose prior (radius 1, near 0.5, far 1.5, 32x32 pixels, fov
    12), film from the mapping network of random latents, a generator with
    random weights, and an output gradient."""
    from msra_practice_project_tpu_torch.models import pigan

    g = torch.Generator().manual_seed(seed)
    gen = pigan.Generator(pigan.GeneratorConfig(), generator=g)
    z = torch.randn(n_img, gen.cfg.z_dim, generator=g)
    theta, phi = gen.sample_poses(n_img, g)
    with torch.no_grad():
        film = gen.mapping(z)
    res = 32
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


def check_film(torch, FK, n_img, n_pts):
    """K8 and K7 against their plain versions on the card, same inputs, in
    fp32 and bf16, K7 with need_dx False and True; two K7 launches and two
    K8 launches must be bitwise equal.  Returns the max |kernel - plain|
    per kernel, K8's fp32 mode as film_mlp_fwd_f32."""
    x, film, w, dy = film_inputs(torch, FK, n_img, n_pts)
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
            if r >= worst.get(kern, -1.0):
                worst[kern], worst_key[kern] = r, key
            print(f"    bf16={bf16} {key:5s} max|err| {err:.3e} "
                  f"{'rel frob' if bf16 else 'err/max'} {r:.3e} max|ref| "
                  f"{float(b.abs().max()):.3e}", flush=True)
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


def time_kernels(torch, K, names, n, reps):
    """{kernel: {ms, plain_ms, bound_ms, bound_by}} for the NeRF kernels in
    `names` (bf16, the path's flags) at n points."""
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
    return {name: {"ms": time_ms(torch, runs[name][0], reps),
                   "plain_ms": time_ms(torch, runs[name][1], 5), **b[name]}
            for name in names}


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


def run_train(torch, iterations, startup, timed, window=None):
    """train_nerf.train on the lego recipe (synthetic scene at 400x400) in a
    temporary directory; its last `timed` steps are one window, timed with
    CUDA events, with `window` entered for them.  Returns (ms/step over the
    window, rays per step, the metric log, checkpoint written, PNG
    written)."""
    from msra_practice_project_tpu_torch.core.config import (
        CONFIG_ROOT, NERF_TRAIN_DEFAULTS, load_config, resolve)
    from msra_practice_project_tpu_torch.train import train_nerf

    cfg = resolve(load_config(os.path.join(CONFIG_ROOT, "nerf", "lego.json")),
                  NERF_TRAIN_DEFAULTS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        cfg.update(output_path=out_dir, experiment_name="lego_smoke",
                   iterations=iterations, start_up_itrs=startup, i_print=10,
                   i_save=iterations, i_image=iterations, data_size=400)
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


def main_path(torch, K, iterations, startup, timed):
    """The main path with every launch counter set to 0 just before it and
    read just after; K1 and K2, K2's delta chain and its split-K pass must
    run twice per step, K3-K6 never."""
    reset_counts()
    ms, batch, log, ckpt, png = run_train(torch, iterations, startup, timed)
    launches = {k.__name__: k.launches for k in K.KERNELS}
    launches["dw_splitk"] = dw_launches()
    launches["nerf_mlp_deltas"] = K.nerf_mlp_deltas.launches
    losses = log["loss"]
    rays = batch / (ms / 1e3)
    print(f"  losses first/last {losses[0]:.5f}/{losses[-1]:.5f}, launches "
          f"{launches}, ckpt {ckpt}, png {png}", flush=True)
    print(f"  window of the last {timed} steps (CUDA events): {ms:.3f} "
          f"ms/step, {rays:,.0f} rays/s", flush=True)
    if not (len(losses) == iterations
            and all(v == v and abs(v) != float("inf") for v in losses)
            and launches == {
                **{k.__name__: 2 * iterations if k in (
                    K.nerf_mlp_fwd_save, K.nerf_mlp_bwd_saved) else 0
                   for k in K.KERNELS}, "dw_splitk": 2 * iterations,
                "nerf_mlp_deltas": 2 * iterations}
            and ckpt and png):
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
    never.  Test PSNR must exceed the tool's 28 dB.  Then
    eval.test_nerf.run on the trained experiment (2 views per split), whose
    test.json must hold the JAX test_nerf's keys, lpips null (no weights) and
    perceptual_metric "1-msssim"."""
    from msra_practice_project_tpu_torch.eval import test_nerf
    tool = load_tool("torch_validate_nerf")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quality_") as out:
        reset_counts()
        res = tool.main(QUALITY_STEPS, QUALITY_SIZE, "easy", out_dir=out)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in K.KERNELS}
        launches["dw_splitk"] = dw_launches()
        launches["nerf_mlp_deltas"] = K.nerf_mlp_deltas.launches
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
    want = {**{k.__name__: 2 * steps if k in (
        K.nerf_mlp_fwd_save, K.nerf_mlp_bwd_saved) else 0
        for k in K.KERNELS}, "dw_splitk": 2 * steps,
        "nerf_mlp_deltas": 2 * steps}
    if launches != want:
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


def film_bounds(FK, n_img, n_pts, w):
    """(K8 ms, K8 bound_by, K7 ms, K7 bound_by): the least time for the work
    of one launch, the larger of its bytes over HBM's rate, its MACs over
    the bf16 tensor-core rate and its sines over the fp32 rate."""
    wbytes = sum(t.numel() * t.element_size() for t in w)
    film_bytes = n_img * FK.N_FILM * 2 * FK.HID * 4
    n = n_img * n_pts
    fwd_macs, bwd_macs = film_macs()
    out = []
    for b, macs, sines in (
            (n * 64 + wbytes + film_bytes, fwd_macs, 2304),
            (n * 64 + wbytes + 2 * film_bytes + FK.GRAD_TOTAL * 4, bwd_macs,
             2 * 2304)):
        t = {"bytes": b / HBM_BYTES_PER_S * 1e3,
             "operations": max(2 * macs * n / BF16_FLOP_PER_S,
                               SINE_OPS * sines * n / FP32_FLOP_PER_S) * 1e3}
        by = max(t, key=t.get)
        out += [t[by], by]
    return out


def film_f32_bound(FK, n_img, n_pts, w):
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
                           SINE_OPS * 2304 * n / FP32_FLOP_PER_S) * 1e3}
    by = max(t, key=t.get)
    return t[by], by, 2 * macs * n / FP32_FLOP_PER_S * 1e3


def time_film(torch, FK, n_img, n_pts, reps):
    """K8 and K7 (bf16, need_dx=False as the generator calls it) per launch
    beside their plain versions (sliced over images) and their bounds."""
    x, film, w, dy = film_inputs(torch, FK, n_img, n_pts, seed=1)
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
     res["fwd_f32_fma_ms"]) = film_f32_bound(FK, n_img, n_pts, wf)
    b1, by1, b2, by2 = film_bounds(FK, n_img, n_pts, wk)
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
    demo = dict.fromkeys(("film_mlp_fwd", "film_mlp_fwd_f32"), 0)
    save_demo_grid = train_pigan.save_demo_grid

    def counted_demo_grid(*args, **kwargs):
        before = (FK.film_mlp_fwd.launches, FK.film_mlp_fwd.launches_f32)
        save_demo_grid(*args, **kwargs)
        demo["film_mlp_fwd"] += FK.film_mlp_fwd.launches - before[0]
        demo["film_mlp_fwd_f32"] += FK.film_mlp_fwd.launches_f32 - before[1]

    train_pigan.save_demo_grid = counted_demo_grid
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            cfg.update(output_path=out_dir, experiment_name="pigan_smoke",
                       **overrides)
            reset_counts()
            res = train_pigan.train(cfg, timed_steps=timed,
                                    window_end=window_end, window=window)
            torch.cuda.synchronize()
            launches = {k.__name__: k.launches for k in FK.KERNELS}
            launches["film_mlp_fwd_f32"] = FK.film_mlp_fwd.launches_f32
            launches["dw_splitk"] = dw_launches()
            last = cfg["iterations"][-1]
            log = os.path.join(out_dir, "pigan_smoke")
            ckpt = os.path.exists(os.path.join(log, f"{last:06d}.ckpt"))
            png = os.path.exists(os.path.join(log, f"{last:06d}.png"))
    finally:
        train_pigan.save_demo_grid = save_demo_grid
        os.environ.pop("MSRA_TPU_FUSED_FILM", None)
        if old is not None:
            os.environ["MSRA_TPU_FUSED_FILM"] = old
    return res["window_ms"] / timed, launches, res["loss_log"], ckpt, png, demo


def pigan_path(torch, FK, mode, overrides, timed, window_end, want,
               files=False):
    """One pi-GAN run; fails unless every loss is finite, each kernel
    launched `want[name]` times per iteration besides the launches counted
    around the demo grids (K8 in mode 1's fp32 only, and at least one when
    a grid is written), the split-K pass at least once per K7 launch (once
    per chunk of images) and, with `files`, the last iteration wrote its
    checkpoint and its demo grid."""
    ms, launches, log, ckpt, png, demo = run_pigan(
        torch, FK, mode, overrides, timed, window_end)
    n_it = overrides["iterations"][-1]
    batch = overrides.get("batch_size", [64])[0]
    losses = log["d_loss"] + log["g_loss"]
    finite = (len(losses) == 2 * n_it
              and all(v == v and abs(v) != float("inf") for v in losses))
    per_it = {k: (v - demo.get(k, 0)) / n_it
              for k, v in launches.items() if k != "dw_splitk"}
    demo_ok = (demo["film_mlp_fwd_f32"]
               == demo["film_mlp_fwd"] * (mode == 1)
               and (demo["film_mlp_fwd"] > 0 or not files))
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


def sass_counts(sass, kernels):
    """({kernel: [HGMMA, HMMA, HGMMA on TF32]} over the functions whose
    names contain one of `kernels`, the HMMA count over every function)."""
    import re
    counts, cur, hmma_all = {}, None, 0
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)|\.text\.([^\s,:]+)", line)
        if m:
            name = m.group(1) or m.group(2)
            cur = next((k for k in kernels if k in name), None)
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
    library, NERF_TC_KERNELS of the NeRF one) has HGMMA (wgmma) and no HMMA
    (WMMA or mma.sync) in its SASS, K8's fp32 kernel (TF32_KERNEL) has
    HGMMA, all of it on TF32 operands, and no HMMA, and the NeRF library
    has no HMMA at all; returns {kernel: (HGMMA count, HMMA count, HGMMA
    count on TF32)}."""
    out, ok = {}, True
    for name, kernels in (("film_mlp", TC_KERNELS + (TF32_KERNEL,)),
                          ("nerf_mlp", NERF_TC_KERNELS)):
        tool, sass = sass_of(build, name, libs[name])
        counts, hmma_all = sass_counts(sass, kernels)
        good = (set(counts) == set(kernels)
                and all(g > 0 and h == 0 for g, h, _ in counts.values())
                and all((t == g) == (k == TF32_KERNEL)
                        for k, (g, _, t) in counts.items())
                and (name == "film_mlp" or hmma_all == 0))
        ok = ok and good
        print(f"  SASS of {name} ({tool}): " + "; ".join(
            f"{k} HGMMA {g} ({t} on TF32), HMMA {h}"
            for k, (g, h, t) in counts.items())
            + f"; HMMA in the whole library {hmma_all} -> "
            f"{'ok' if good else 'FAIL'}", flush=True)
        out.update({k: tuple(v) for k, v in counts.items()})
    if not ok:
        raise SystemExit("the per-tile kernels are not on wgmma")
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

    phase("device and build")
    smi = nvidia_smi_line()
    print(f"  {smi}", flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    libs = build.load_all(["nerf_mlp", "film_mlp"])
    print(f"  built {', '.join(os.path.basename(l._name) for l in libs)} "
          f"({time.perf_counter() - t0:.1f} s, in parallel)", flush=True)
    sass = check_sass(build, {"nerf_mlp": libs[0]._name,
                              "film_mlp": libs[1]._name})
    torch.cuda.synchronize()
    summary, kernels = {}, []

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
    k3456 = ("nerf_mlp_fwd", "nerf_mlp_fwd_pipelined", "nerf_mlp_bwd",
             "nerf_mlp_dx")
    for label, n in (("coarse", COARSE_N), ("fine", FINE_N)):
        times[label] = t = time_kernels(torch, K, k3456, n, 25)
        print(f"  {label} N={n}: " + "; ".join(
            f"{name} {t[name]['ms']:.4f} ms (plain {t[name]['plain_ms']:.4f},"
            f" bound {t[name]['bound_ms']:.4f} {t[name]['bound_by']})"
            for name in k3456), flush=True)
        torch.cuda.synchronize()
    for name, line in (("nerf_mlp_fwd", 279), ("nerf_mlp_fwd_pipelined", 294),
                       ("nerf_mlp_bwd", 500), ("nerf_mlp_dx", 605)):
        kernels.append(kernel_entry(
            name, src, f"{pallas}:{line}", rl_launches[name], errs[name],
            times["coarse"][name], times["fine"][name], f"N={COARSE_N}",
            f"N={FINE_N}", "tools/torch_roofline_nerf.py, batch 1024, "
            "main + fwdwall"))

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
                 "film_mlp_bwd": 1.0}, files=True)
    torch.cuda.synchronize()
    phase("pi-GAN mode 2 (K8 forward in bf16): stage 0, 8 iterations")
    ms2, launches2, _, _ = pigan_path(
        torch, FK, 2, dict(iterations=[8], fade_in_itrs=[0],
                           batch_size=[64], resolution=[32], i_print=4,
                           i_save=1000, i_image=1000),
        4, 8, {"film_mlp_fwd": 4.0, "film_mlp_fwd_f32": 0.0,
               "film_mlp_bwd": 1.0})
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

    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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

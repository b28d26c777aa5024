#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (msra_practice_project_tpu_torch) on
one NVIDIA GPU.

Phases, one line each; any failure exits non-zero:
  1. the card's name and power limit; build the CUDA kernels from the sources
     in this checkout;
  2. hold each kernel against its plain PyTorch version at the coarse- and
     fine-pass shapes (65,536 and 196,608 points), in fp32 and in bf16, and
     check that the backward is bitwise reproducible;
  3. the main path: `train_nerf.train` on the lego recipe (1024 rays, 64+128
     samples, full-width NeRF) for 30 iterations, 10 of them start-up, on the
     synthetic Blender scene; both kernels must be launched twice per step.
     Its last 20 steps are one timed window (CUDA events): ms/step and
     rays/s;
  4. the same run again with torch.profiler (device activity only) on for
     its timed window: the device's busy time, the window's wall time and
     idle share, and the device time by kernel, all from that one window
     (the profiler's own host cost shows as the gap to phase 3's ms/step);
  5. per-kernel times at the coarse and fine shapes beside the plain version
     and the least time the card could take.
The second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
COARSE_N, FINE_N = 1024 * 64, 1024 * 192


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
        g_k = K.nerf_mlp_bwd_saved(wk, dy, acts_k, bf16)
        g_k2 = K.nerf_mlp_bwd_saved(wk, dy, acts_k, bf16)
        g_p = K.nerf_mlp_bwd_saved_plain(wk, dy, acts_k, bf16)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(g_k, g_k2))
        worst, max_abs = 0.0, 0.0
        for key, a, b in zip(K.PACK_KEYS, g_k, g_p):
            err = float((a - b).abs().max())
            max_abs = max(max_abs, err)
            if bf16:
                r = rel_frob(a, b) if float(b.norm()) > 0 else err
                worst = max(worst, r)
                bad = r > 5e-2
            else:
                scale = float(b.abs().max())
                worst = max(worst, err / max(scale, 1e-30))
                bad = err > 1e-4 * scale
            if bad:
                print(f"  K2 bf16={bf16}: {key} max|err| {err:.3e} "
                      f"rel {rel_frob(a, b):.3e} max|ref| "
                      f"{float(b.abs().max()):.3e}", flush=True)
        ok = same and worst <= (5e-2 if bf16 else 1e-4)
        print(f"  K2 bf16={bf16}: worst {'rel frob' if bf16 else 'err/max'} "
              f"{worst:.3e}, max|err| {max_abs:.3e}, bitwise repeat {same} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit("K2 disagrees with its plain version or is not "
                             "reproducible")
        if bf16:
            report = {"nerf_mlp_fwd_save": out_err,
                      "nerf_mlp_bwd_saved": max_abs}
        del acts_k, acts_p, g_k, g_k2, g_p
        torch.cuda.synchronize()
    return report


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


def mlp_macs():
    """Multiply-adds per point of the NeRF MLP's layers (unpadded)."""
    layers = [(60, 256)] + [(256, 256)] * 4 + [(316, 256)] + [(256, 256)] * 2 \
        + [(256, 1), (256, 256), (280, 128), (128, 3)]
    fwd = sum(i * o for i, o in layers)
    # backward without dx: dW for every layer, plus delta @ W^T for every
    # layer whose input is an activation (not the PEs) and the two heads
    # rebuilt from h7/h9
    chain = (4 * 256 * 256 + 256 * 256 + 2 * 256 * 256 + 256 * 1
             + 256 * 256 + 256 * 128 + 128 * 3)
    return fwd, fwd + chain + 256 + 128 * 3


def bounds(K, n, w):
    """(K1 ms, K2 ms, K1 bound_by, K2 bound_by): least time for the work."""
    wbytes = sum(t.numel() * (2 if k.startswith("W") else 4)
                 for k, t in zip(K.PACK_KEYS, w))
    fwd_macs, bwd_macs = mlp_macs()
    act_bytes = K.ACT_PAD * 2
    k1_bytes = n * (K.IN_PAD * 4 + K.OUT_PAD * 4 + act_bytes) + wbytes
    k2_bytes = n * (K.OUT_PAD * 4 + act_bytes) + wbytes + K.GRAD_TOTAL * 4
    out = []
    for b, macs in ((k1_bytes, fwd_macs), (k2_bytes, bwd_macs)):
        t_b = b / HBM_BYTES_PER_S * 1e3
        t_o = 2 * macs * n / BF16_FLOP_PER_S * 1e3
        out.append((max(t_b, t_o), "bytes" if t_b >= t_o else "operations"))
    return out


def time_kernels(torch, K, n, reps):
    x, w, dy = seeded_inputs(torch, K, n, seed=1)
    x, dy = x.cuda(), dy.cuda()
    wk = [t.cuda() for t in K.kernel_weights(w, True)]
    _, acts = K.nerf_mlp_fwd_save(x, wk, True)
    res = {
        "fwd_ms": time_ms(torch, lambda: K.nerf_mlp_fwd_save(x, wk, True),
                          reps),
        "fwd_plain_ms": time_ms(
            torch, lambda: K.nerf_mlp_fwd_save_plain(x, wk, True), 5),
        "bwd_ms": time_ms(
            torch, lambda: K.nerf_mlp_bwd_saved(wk, dy, acts, True), reps),
        "bwd_plain_ms": time_ms(
            torch, lambda: K.nerf_mlp_bwd_saved_plain(wk, dy, acts, True),
            5),
    }
    (b1, by1), (b2, by2) = bounds(K, n, wk)
    res.update(fwd_bound_ms=b1, fwd_bound_by=by1, bwd_bound_ms=b2,
               bwd_bound_by=by2)
    return res


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


def main_path(torch, K, iterations, startup, timed):
    """The main path with every launch counter set to 0 just before it and
    read just after; both kernels must run twice per step."""
    K.reset_launch_counts()
    ms, batch, log, ckpt, png = run_train(torch, iterations, startup, timed)
    launches = {k.__name__: k.launches for k in K.KERNELS}
    losses = log["loss"]
    rays = batch / (ms / 1e3)
    print(f"  losses first/last {losses[0]:.5f}/{losses[-1]:.5f}, launches "
          f"{launches}, ckpt {ckpt}, png {png}", flush=True)
    print(f"  window of the last {timed} steps (CUDA events): {ms:.3f} "
          f"ms/step, {rays:,.0f} rays/s", flush=True)
    if not (len(losses) == iterations
            and all(v == v and abs(v) != float("inf") for v in losses)
            and all(n == 2 * iterations for n in launches.values())
            and ckpt and png):
        raise SystemExit("main path check failed")
    return launches, ms, rays


def profiled_window(torch, iterations, startup, timed):
    """The same train run with torch.profiler (device activity only) on for
    the timed window: the device's busy time (union of its kernel
    intervals), the window's wall time and idle share, and the time by
    kernel, all from that one window."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    ms = run_train(torch, iterations, startup, timed, window=prof)[0]
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = [(e["name"], e["ts"], e["dur"])
                      for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "kernel" and "dur" in e]
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
    print(f"  window of the last {timed} steps, profiler on: {ms:.3f} "
          f"ms/step; device busy {busy:.3f} ms/step, idle share "
          f"{idle:.3f}", flush=True)
    rows = sorted(((t / timed, n / timed, name)
                   for name, (t, n) in by_name.items()), reverse=True)
    for t, n, name in rows[:12]:
        print(f"  {t:8.4f} ms/step  x{n:<4g} {name[:100]}", flush=True)
    return ms, busy, idle


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from msra_practice_project_tpu_torch.ops.kernels import build
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
    lib = build.load("nerf_mlp")
    print(f"  built {os.path.basename(lib._name)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    torch.cuda.synchronize()

    errs = {}
    for n in (COARSE_N, FINE_N):
        phase(f"kernels vs plain versions at N={n}")
        for name, err in check_kernels(torch, K, n).items():
            errs[name] = max(err, errs.get(name, 0.0))
        torch.cuda.synchronize()

    phase("main path: train_nerf.train, lego recipe, 30 iterations")
    launches, step_ms, rays = main_path(torch, K, 30, 10, 20)
    torch.cuda.synchronize()

    phase("profile: the same train run, torch.profiler on for its window")
    prof_ms, busy, idle = profiled_window(torch, 30, 10, 20)
    torch.cuda.synchronize()

    phase("kernel timings (bf16, CUDA events, median)")
    times = {}
    for label, n in (("coarse", COARSE_N), ("fine", FINE_N)):
        times[label] = time_kernels(torch, K, n, 25)
        t = times[label]
        print(f"  {label} N={n}: K1 {t['fwd_ms']:.4f} ms (plain "
              f"{t['fwd_plain_ms']:.4f}, bound {t['fwd_bound_ms']:.4f} "
              f"{t['fwd_bound_by']}); K2 {t['bwd_ms']:.4f} ms (plain "
              f"{t['bwd_plain_ms']:.4f}, bound {t['bwd_bound_ms']:.4f} "
              f"{t['bwd_bound_by']})", flush=True)
        torch.cuda.synchronize()

    src = "msra_practice_project_tpu_torch/ops/kernels/csrc/nerf_mlp.cu"
    kernels = []
    for name, pre, replaces in (
            ("nerf_mlp_fwd_save", "fwd",
             "msra_practice_project_tpu/ops/pallas/nerf_mlp.py:336"),
            ("nerf_mlp_bwd_saved", "bwd",
             "msra_practice_project_tpu/ops/pallas/nerf_mlp.py:353")):
        c, f = times["coarse"], times["fine"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": c[f"{pre}_ms"],
            "plain_ms": c[f"{pre}_plain_ms"], "bound_ms": c[f"{pre}_bound_ms"],
            "bound_by": c[f"{pre}_bound_by"], "library_ms": None,
            "shape": f"N={COARSE_N} (coarse pass)",
            "fine": {"shape": f"N={FINE_N}", "ms": f[f"{pre}_ms"],
                     "plain_ms": f[f"{pre}_plain_ms"],
                     "bound_ms": f[f"{pre}_bound_ms"],
                     "bound_by": f[f"{pre}_bound_by"]},
        })
    print(json.dumps({"train_step_ms": step_ms, "train_rays_per_s": rays,
                      "profiled_step_ms": prof_ms, "device_busy_ms": busy,
                      "profiled_idle_share": idle}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Attribute the pi-GAN train-step time at a given stage geometry, for the
PyTorch/CUDA port (the counterpart of tools/profile_pigan.py).

Times each part of the adversarial step apart, on CUDA events after a
warm-up, under the trainer's precision (``set_plain_precision``: strict
fp32, deterministic cuDNN):
  G fwd | G fwd+bwd | D fwd | D fwd+bwd | R1 (double backward) |
  D's adversarial path | d_step | g_step
The generator's trunk runs in the mode ``MSRA_TPU_FUSED_FILM`` picks (1
on CUDA when unset: K8 in fp32 forward, K7 backward); the rows that run G
print their K8 and K7 launches per call.  For D's three rows, one
torch.profiler window names the five device kernels with the most time
(which convolution, FFT and GEMM kernels cuDNN and cuBLAS chose).  The last
line is a JSON object of the readings.

Run: python3 tools/torch_profile_pigan.py [batch] [resolution] [--device cpu]
Defaults: stage 1 of configs/pi_gan/test.json (batch 16 at 64^2, 8 + 16
samples, z 1024); stage 0 is ``64 32``.  On the CPU the times are the host
clock's and no kernel is profiled.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from msra_practice_project_tpu_torch import (  # noqa: E402
    resolve_device, set_plain_precision)
from msra_practice_project_tpu_torch.models import pigan  # noqa: E402
from msra_practice_project_tpu_torch.ops.kernels import (  # noqa: E402
    film_mlp as FK)
from msra_practice_project_tpu_torch.train import common  # noqa: E402
from msra_practice_project_tpu_torch.train.train_pigan import (  # noqa: E402
    loss_f, make_gan_steps, r1_penalty)

D_ROWS = ("D fwd", "D fwd+bwd", "R1 double-grad")


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, device, n=20, warmup=3) -> float:
    """ms per call of ``fn()`` over ``n`` calls after ``warmup``: CUDA
    events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = common.clock(device)
    for _ in range(n):
        fn()
    t1 = common.clock(device)
    if device.type == "cuda":
        t1.synchronize()
        return t0.elapsed_time(t1) / n
    return 1e3 * (t1 - t0) / n


def film_launches() -> dict:
    """The FiLM kernels' launch counters: K8 (all, fp32) and K7."""
    return {"k8": FK.film_mlp_fwd.launches,
            "k8_f32": FK.film_mlp_fwd.launches_f32,
            "k7": FK.film_mlp_bwd.launches}


def launches_per_call(fn) -> dict:
    """K8 (all, fp32) and K7 launches of one call of ``fn()``."""
    before = film_launches()
    fn()
    return {k: v - before[k] for k, v in film_launches().items()}


def top_kernels(fn, device, k=5) -> list:
    """[(name, device ms)] of the ``k`` device kernels with the most time
    in one call of ``fn()`` under torch.profiler, from its trace."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:k]


def grads(loss, params):
    return torch.autograd.grad(loss, params, allow_unused=True)


def build(batch, res, device, gen_overrides=None):
    """G and D from fixed seeds, a latent and a real batch, a device
    generator for the poses and the jitter, and the stage's steps."""
    cfg = pigan.GeneratorConfig(**{"z_dim": 1024, "resolution": res,
                                   "coarse_samples": 8, "fine_samples": 16,
                                   **(gen_overrides or {})})
    gen = pigan.Generator(cfg, generator=torch.Generator().manual_seed(
        0)).to(device)
    disc = pigan.Discriminator(generator=torch.Generator().manual_seed(
        1)).to(device)
    host = torch.Generator().manual_seed(2)
    z = torch.randn(batch, cfg.z_dim, generator=host).to(device)
    real = torch.rand(batch, 3, res, res, generator=host).to(device)
    rgen = torch.Generator(device=device).manual_seed(4)
    g_opt = common.adam(gen.parameters(), common.interp_lr(5e-5, 1e-5, 500),
                        betas=(0.0, 0.9))
    d_opt = common.adam(disc.parameters(), common.interp_lr(4e-4, 1e-4, 500),
                        betas=(0.0, 0.9))
    d_step, g_step = make_gan_steps(gen, disc, g_opt, d_opt, res)
    return gen, disc, z, real, rgen, d_step, g_step


def main(batch=16, res=64, device=None, n=20, warmup=3,
         gen_overrides=None) -> dict:
    """Every row's ms, images/s, the K8/K7 launches of the rows that run G
    and D's rows' top device kernels.  ``gen_overrides`` replaces fields of
    the GeneratorConfig (smaller runs)."""
    device = resolve_device(device)
    set_plain_precision()
    gen, disc, z, real, rgen, d_step, g_step = build(batch, res, device,
                                                     gen_overrides)
    g_params, d_params = list(gen.parameters()), list(disc.parameters())
    alpha = 0.5

    def g_fwd():
        with torch.no_grad():
            return gen(z, res, generator=rgen)

    def g_fwdbwd():
        return grads(gen(z, res, generator=rgen).sum(), g_params)

    def d_fwd():
        with torch.no_grad():
            return disc(real, res, alpha)

    def d_fwdbwd():
        return grads(disc(real, res, alpha).sum(), d_params)

    def r1_only():
        x = real.detach().requires_grad_(True)
        return grads(r1_penalty(disc(x, res, alpha), x), d_params)

    def d_adv_path():
        """d_step's G-dependent half: G fwd + D fwd/bwd on fake."""
        with torch.no_grad():
            fake = gen(z, res, generator=rgen)
        return grads(-loss_f(disc(fake, res, alpha)).mean(), d_params)

    rows = [("G fwd (render)", g_fwd), ("G fwd+bwd", g_fwdbwd),
            ("D fwd", d_fwd), ("D fwd+bwd", d_fwdbwd),
            ("R1 double-grad", r1_only),
            ("D adv path (G fwd + D f/b on fake)", d_adv_path),
            ("full d_step", lambda: d_step(real, z, alpha, generator=rgen)),
            ("full g_step", lambda: g_step(z, alpha, generator=rgen))]
    ms, launches, kernels = {}, {}, {}
    for name, fn in rows:
        ms[name] = timeit(fn, device, n, warmup)
        if name not in D_ROWS:
            launches[name] = launches_per_call(fn)
        elif device.type == "cuda":
            kernels[name] = top_kernels(fn, device)

    nc, nf = gen.cfg.coarse_samples, gen.cfg.fine_samples
    print(f"batch {batch} @ {res}^2, {nc}+{nf} samples "
          f"({batch * res * res * (nc + nf):,} MLP points per G fwd); "
          f"{device.type}, "
          + ("CUDA events" if device.type == "cuda" else "host clock"))
    for name, _ in rows:
        extra = ""
        if name in launches:
            c = launches[name]
            extra = (f"   K8 {c['k8']} ({c['k8_f32']} fp32), K7 {c['k7']} "
                     "per call")
        print(f"  {name:<38s} {ms[name]:8.2f} ms{extra}")
    full = ms["full g_step"] + ms["full d_step"]
    print(f"  TOTAL d+g {full:8.2f} ms  -> {batch / full * 1e3:.1f} imgs/s")
    for name in D_ROWS:
        if name not in kernels:
            print(f"  {name}: device kernels not measured ({device.type})")
            continue
        print(f"  {name}: top device kernels of one call")
        for kname, kms in kernels[name]:
            print(f"    {kms:8.3f} ms  {kname[:110]}")
    return {"batch": batch, "resolution": res, "device": device.type,
            "ms": ms, "total_ms": full, "imgs_per_s": batch / full * 1e3,
            "launches": launches, "d_kernels": kernels}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16)
    p.add_argument("resolution", nargs="?", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: CUDA)")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args(sys.argv[1:])
    print(json.dumps(main(a.batch, a.resolution, a.device)))

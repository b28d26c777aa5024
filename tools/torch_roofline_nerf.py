#!/usr/bin/env python3
"""Roofline breakdown of the NeRF train step for the PyTorch/CUDA port (the
port of tools/roofline_nerf.py).

Times each stage of the hot loop alone, warm, as the mean of back-to-back
calls in one CUDA-event window, at the lego recipe's geometry: `batch` rays,
64 coarse + 64 + 128 fine samples each (262,144 MLP points at batch 1024):
  * the full train step (train_nerf.make_train_step: K1 and K2 twice);
  * the fused MLP (fused_nerf_apply at its default flags) on the step's
    points: forward under no_grad (K3), backward alone (K5 + K4),
    forward + backward (K3 + K5 + K4);
  * the plain NeRFModel in fp32 (forward_plain): forward, forward +
    backward;
  * stratified sampling + sample_pdf + sort;
  * compositing forward + backward, coarse and fine pass;
  * Adam alone;
  * 10 steps back to back in one window.
`fwdwall` mode times windows of 10 forward passes over the same points of
K3, K1, K6 and the plain forward with the same bf16 rounding (best of 3).

The first line is the device (on a card, its name and power limit as
nvidia-smi prints them), then one line per probe; the last line is one JSON
object with every number and, per probe, each kernel's launches in one call.
Runs on CUDA unless --device cpu is given (the plain versions then stand in
for the kernels, and times are the host's).

Usage: python3 tools/torch_roofline_nerf.py [batch] [fwdwall] [--device cpu]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from msra_practice_project_tpu_torch import (  # noqa: E402
    resolve_device, set_plain_precision)
from msra_practice_project_tpu_torch.models.nerf import nerf_model  # noqa: E402
from msra_practice_project_tpu_torch.ops.composite import (  # noqa: E402
    raw_to_outputs)
from msra_practice_project_tpu_torch.ops.kernels import (  # noqa: E402
    nerf_mlp as K)
from msra_practice_project_tpu_torch.ops.sampling import (  # noqa: E402
    sample_pdf, stratified_samples)
from msra_practice_project_tpu_torch.train import common, train_nerf  # noqa: E402

NC, NF = 64, 128
PTS_PER_RAY = NC + NC + NF
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet)


def device_line(device: torch.device) -> str:
    if device.type != "cuda":
        return f"device: {device}"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, device, iters=20, warmup=3) -> float:
    """ms per call: the mean of `iters` back-to-back calls in one window
    (CUDA events on a card), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    _sync(device)
    t0 = common.clock(device)
    for _ in range(iters):
        fn()
    t1 = common.clock(device)
    if device.type == "cuda":
        t1.synchronize()
        return t0.elapsed_time(t1) / iters
    return (t1 - t0) * 1e3 / iters


def launches_of(fn, device) -> dict:
    """Each kernel's launches in one call of fn (the counters are read, not
    reset: a caller's count over a whole run stays whole)."""
    before = {k.__name__: k.launches for k in K.KERNELS}
    fn()
    _sync(device)
    return {k.__name__: k.launches - before[k.__name__] for k in K.KERNELS
            if k.launches != before[k.__name__]}


def make_batch(g, batch, device):
    """Rays around a radius-4 orbit looking at the origin, with random rgba."""
    ro = torch.randn(batch, 3, generator=g) * 0.1 + torch.tensor([0, 0, 4.0])
    rd = -ro / ro.norm(dim=-1, keepdim=True) + 0.1 * torch.randn(
        batch, 3, generator=g)
    return torch.cat([ro, rd, torch.rand(batch, 4, generator=g)],
                     1).to(device)


def main_probes(batch, device, iters):
    g = torch.Generator().manual_seed(0)
    coarse = nerf_model(generator=g).to(device)
    fine = nerf_model(generator=g).to(device)
    params = [*coarse.parameters(), *fine.parameters()]
    cparams = list(coarse.parameters())
    opt = common.adam(params, common.exponential_lr(5e-4, 500))
    cfg = {"use_fine_model": True, "use_alpha": False, "render_near": 2.0,
           "render_far": 6.0, "render_coarse_sample_num": NC,
           "render_fine_sample_num": NF}
    b = make_batch(g, batch, device)
    n_pts = batch * PTS_PER_RAY
    dev_gen = torch.Generator(device=device).manual_seed(1)
    res, launches = {"batch": batch, "points": n_pts}, {}

    def probe(name, fn, n=iters, warmup=3):
        launches[name] = launches_of(fn, device)
        res[f"{name}_ms"] = t = timeit(fn, device, n, warmup)
        return t

    step = train_nerf.make_train_step(coarse, fine, opt, cfg, device)
    t_step = probe("step", lambda: step(b, generator=dev_gen))
    res["rays_per_s"] = batch / t_step * 1e3
    print(f"full step             {t_step:8.3f} ms   "
          f"({res['rays_per_s']:,.0f} rays/s)", flush=True)

    x = torch.rand(n_pts, 6, generator=g).to(device)

    def fwd():
        with torch.no_grad():
            return K.fused_nerf_apply(coarse, x).sum()

    out_sum = K.fused_nerf_apply(coarse, x).sum()
    t_fwd = probe("mlp_fwd", fwd)
    t_b = probe("mlp_bwd", lambda: torch.autograd.grad(out_sum, cparams,
                                                       retain_graph=True))
    t_fb = probe("mlp_fwd_bwd", lambda: torch.autograd.grad(
        K.fused_nerf_apply(coarse, x).sum(), cparams))
    del out_sum
    print(f"fused MLP fwd ({n_pts:,}) {t_fwd:8.3f} ms\n"
          f"fused MLP bwd only    {t_b:8.3f} ms  (K5 + K4, graph kept)\n"
          f"fused MLP fwd+bwd     {t_fb:8.3f} ms", flush=True)

    def plain_fwd():   # the plain fp32 forward (no_grad's own route is
        with torch.no_grad():   # the fused fp32 kernel on CUDA)
            return coarse.forward_plain(x).sum()

    t_px = probe("plain_fwd", plain_fwd)
    t_pfb = probe("plain_fwd_bwd", lambda: torch.autograd.grad(
        coarse(x).sum(), cparams))
    print(f"plain fp32 MLP fwd / f+b {t_px:8.3f} / {t_pfb:.3f} ms",
          flush=True)

    def samp():
        z, mids = stratified_samples(2.0, 6.0, NC, (batch,),
                                     generator=dev_gen, device=device)
        w = torch.rand(batch, NC - 2, generator=dev_gen, device=device)
        return torch.sort(torch.cat([z, sample_pdf(mids, w, NF)], -1), -1)[0]

    t_samp = probe("sample", samp)
    print(f"sample+pdf+sort       {t_samp:8.3f} ms", flush=True)

    raw_c = torch.rand(batch, NC, 4, generator=g).to(device).requires_grad_()
    raw_f = torch.rand(batch, NC + NF, 4, generator=g).to(
        device).requires_grad_()
    z_c = (torch.rand(batch, NC, generator=g).sort(-1)[0] * 4 + 2).to(device)
    z_f = (torch.rand(batch, NC + NF, generator=g).sort(-1)[0] * 4
           + 2).to(device)
    rd = b[:, 3:6]

    def comp():
        rgb_c = raw_to_outputs(raw_c, z_c, rd, True)[0]
        rgb_f = raw_to_outputs(raw_f, z_f, rd, True)[0]
        return torch.autograd.grad((rgb_c ** 2).mean() + (rgb_f ** 2).mean(),
                                   (raw_c, raw_f))

    t_comp = probe("composite", comp)
    print(f"composite f+b (c+f)   {t_comp:8.3f} ms", flush=True)

    for p in params:
        p.grad = torch.ones_like(p)
    t_adam = probe("adam", opt.step)
    print(f"adam update           {t_adam:8.3f} ms", flush=True)

    def ten():
        for _ in range(10):
            step(b, generator=dev_gen)

    t_ten = probe("steps10", ten, n=max(1, iters // 4), warmup=1)
    res["steps10_ms_per_step"] = t_ten / 10
    print(f"10 steps back to back {t_ten:8.3f} ms  ({t_ten / 10:.3f} "
          f"ms/step, {batch * 10 / t_ten * 1e3:,.0f} rays/s)", flush=True)

    macs = K.macs_per_point()
    flops = 2 * n_pts * (macs["fwd"] + macs["bwd"] + macs["dx"])
    res["mlp_fwd_bwd_tflops"] = flops / (t_fb * 1e-3) / 1e12
    res["sum_of_parts_ms"] = t_fb + t_samp + t_comp + t_adam
    print(f"\nMLP fwd+bwd FLOPs {flops / 1e12:.3f} TF (K3 + K5 + K4); at "
          f"the measured {t_fb:.3f} ms -> {res['mlp_fwd_bwd_tflops']:.1f} "
          f"TFLOP/s effective (H100 bf16 dense peak "
          f"{BF16_FLOP_PER_S / 1e12:.0f})", flush=True)
    print(f"sum of parts {res['sum_of_parts_ms']:.3f} ms vs step "
          f"{t_step:.3f} ms", flush=True)
    return res, launches


def fwdwall_probes(batch, device, passes=10, reps=3):
    n = batch * PTS_PER_RAY
    g = torch.Generator().manual_seed(0)
    model = nerf_model(generator=g).to(device)
    x = (torch.rand(n, 6, generator=g) * 2 - 1).to(device)
    xp = K.pad_points(x)
    packed = K.pack_nerf_params(model)
    w = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS], True)
    flop = 2 * n * K.macs_per_point()["fwd"]
    res, launches = {"batch": batch, "points": n}, {}
    for name, label, fn in (
            ("k3", "K3 fwd, no spill    ", lambda: K.nerf_mlp_fwd(xp, w)),
            ("k1", "K1 fwd_save         ", lambda: K.nerf_mlp_fwd_save(xp, w)),
            ("k6", "K6 fwd, pipelined   ",
             lambda: K.nerf_mlp_fwd_pipelined(xp, w)),
            ("plain", "plain fwd (same math)",
             lambda: K.nerf_mlp_fwd_plain(xp, w, True))):
        launches[name] = launches_of(fn, device)
        best = min(timeit(fn, device, passes, 1 if i == 0 else 0)
                   for i in range(reps))
        res[f"{name}_ms"] = best
        res[f"{name}_tflops"] = flop / (best * 1e-3) / 1e12
        print(f"{label}: {best:8.3f} ms  {res[f'{name}_tflops']:6.1f} TF/s "
              f"(bf16 dense peak {BF16_FLOP_PER_S / 1e12:.0f})", flush=True)
    return res, launches


def run(batch: int = 1024, mode: str = "main", device=None,
        iters: int = 20) -> dict:
    """One mode of the tool ("main" or "fwdwall"); prints its lines and
    returns every number, with per-probe launches under "launches"."""
    device = resolve_device(device)
    set_plain_precision()
    head = device_line(device)
    print(head, flush=True)
    print(f"device {device}, batch {batch}, mode {mode}", flush=True)
    if mode == "fwdwall":
        res, launches = fwdwall_probes(batch, device)
    elif mode == "main":
        res, launches = main_probes(batch, device, iters)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return {"mode": mode, "device": head, **res, "launches": launches}


def main(argv) -> int:
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    mode = "fwdwall" if "fwdwall" in argv else "main"
    nums = [a for a in argv if a != "fwdwall"]
    batch = int(nums[0]) if nums else 1024
    t0 = time.perf_counter()
    res = run(batch, mode, device)
    res["wall_s"] = time.perf_counter() - t0
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

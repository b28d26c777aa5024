#!/usr/bin/env python3
"""Data parallelism, exact resume and diagnostics of the PyTorch/CUDA port,
checked on one NVIDIA card (chip_smoke.py's phases 25-27).

  25. Data parallelism on the one card.  NCCL refuses two ranks on one
      device, so two gloo ranks share it (gloo all-reduces CUDA tensors;
      the sharded render gathers through the host); this is a check of
      what the ranks compute, not a scaling figure.
      a. 3 NeRF steps at full width, the lego recipe's samples (64 + 128,
         no alpha loss), 512 rays a rank of one 1024-ray batch, through K1
         and K2: the averaged gradients within 5e-2 relative Frobenius norm
         per tensor (K2's bf16 gate) and the losses within 1e-3 relative of
         one process at 1024 rays at the same weights; a second DP run
         equal bitwise; 2 K1 and 2 K2 launches per step on each rank;
      b. 2 pi-GAN iterations at configs/pi_gan/test.json's stage 0 (z 1024,
         32x32, 8 + 16 samples) in the default mode 1, 32 latents a rank of
         64: D's and G's averaged gradients (5e-2) and the losses (1e-3)
         against one process at the same weights; 4 fp32 K8 launches (no
         bf16 one) and 1 K7 launch per iteration on each rank;
      c. a 100x100 eval view (full-width NeRF, 64 + 128 samples) through
         eval.nerf_common.render_view, its ray tiles split over the ranks,
         equal bitwise to ops.render.render_image over the same tiles from
         the same generator;
      d. a one-rank NCCL group (the backend for one card per rank) running
         one NeRF step through its all-reduce: equal bitwise to a process
         without a group;
      e. the package's dry run on the card (``dryrun.dryrun_multichip(2)``,
         two gloo ranks): its six OK lines, the sharded view equal bitwise
         to one process's.
  26. Exact resume: train_nerf.train on the lego recipe (the synthetic
      scene at 400x400, 5 start-up steps) for 20 steps, against 10 steps
      and a resumed run to 20: the loss histories and the final weights
      equal bitwise (the kernels and cuDNN are deterministic).
  27. profile_steps writes a Chrome trace of steps 11-12 that names K1's
      and K2's kernels; debug_nans is silent on a clean run and raises
      FloatingPointError on a batch poisoned with a NaN.

With ``--nccl N`` (a host with N cards) it runs only the NCCL check
instead: 25a's NeRF steps and 25b's pi-GAN iterations over N NCCL ranks,
one card each (1024 / N rays and 64 / N latents a rank), with 25a's and
25b's gates against one process on card 0 at the same weights.

Prints each check, each phase's seconds, the card's name and power limit,
and as its last line a JSON summary; exits 1 if a check fails, 2 without
CUDA.

Run from the repository root:  python3 tools/torch_dp_check.py [--nccl N]
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

NERF_RAYS, NERF_STEPS, NC, NF = 1024, 3, 64, 128     # lego.json's recipe
PIGAN_BATCH, PIGAN_RES, PIGAN_Z, PIGAN_ITERS = 64, 32, 1024, 2  # test.json
VIEW = 100
DEVICE = "cuda"
BF16_GATE, LOSS_GATE = 5e-2, 1e-3
KERNEL_NAMES = ("nerf_fwd_tc_kernel", "nerf_bwd_delta_tc_kernel",
                "dw_splitk_tc_kernel")


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  {'ok' if ok else 'FAILED'}: {what}", flush=True)
    if not ok:
        raise CheckFailed(what)


def lego_batch(n: int, seed: int = 0) -> torch.Tensor:
    """``[n, 10]`` rays of the lego geometry (origins at radius 4 looking
    at the scene, near 2 / far 6) with random rgba targets."""
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((n, 3), generator=g)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4.0 + 0.15 * torch.randn((n, 3), generator=g)
    return torch.cat([o, d, torch.rand((n, 4), generator=g)], dim=1)


def worst_rel(got, ref) -> float:
    """The largest relative Frobenius error over a list of tensors."""
    return max(float((a.double() - b.double()).norm()
                     / max(float(b.double().norm()), 1e-30))
               for a, b in zip(got, ref))


def same(a, b) -> bool:
    """Bitwise equality of nested lists of tensors and numbers."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _plain():
    from msra_practice_project_tpu_torch import set_plain_precision
    set_plain_precision()


def reset_counts():
    from msra_practice_project_tpu_torch.ops.kernels import (
        dw_splitk, film_mlp, nerf_mlp)
    for mod in (nerf_mlp, film_mlp, dw_splitk):
        mod.reset_launch_counts()


def nerf_counts() -> dict:
    from msra_practice_project_tpu_torch.ops.kernels import nerf_mlp as K
    return {"k1": K.nerf_mlp_fwd_save.launches,
            "k2": K.nerf_mlp_bwd_saved.launches}


def film_counts() -> dict:
    from msra_practice_project_tpu_torch.ops.kernels import film_mlp as FK
    return {"k8": FK.film_mlp_fwd.launches,
            "k8_f32": FK.film_mlp_fwd.launches_f32,
            "k7": FK.film_mlp_bwd.launches}


# -- the spawned ranks (module-level: the spawn start method imports them) --

def nerf_rank(batch, steps):
    from msra_practice_project_tpu_torch import dryrun
    _plain()
    reset_counts()
    out = dryrun.nerf_steps(batch, steps, nc=NC, nf=NF, device="cuda",
                            use_alpha=False)
    out.update(nerf_counts())
    return out


def pigan_rank():
    from msra_practice_project_tpu_torch import dryrun
    _plain()
    reset_counts()
    out = dryrun.pigan_steps(PIGAN_BATCH, stages=((PIGAN_RES, PIGAN_ITERS),),
                             z_dim=PIGAN_Z, samples=(8, 16), device="cuda")
    out.update(film_counts())
    return out


def view_models():
    from msra_practice_project_tpu_torch.models.nerf import nerf_model
    init = torch.Generator().manual_seed(3)
    return tuple(nerf_model(False, generator=init).cuda().eval()
                 for _ in range(2))


VIEW_CFG = {"use_fine_model": True, "render_near": 2.0, "render_far": 6.0,
            "render_coarse_sample_num": NC, "render_fine_sample_num": NF}


def view_rank():
    from msra_practice_project_tpu_torch.eval import nerf_common
    from msra_practice_project_tpu_torch.ops import rays as ray_ops
    _plain()
    models = view_models()
    gen = nerf_common.generator_for(models, seed=5)
    return nerf_common.render_view(VIEW_CFG, models, VIEW, VIEW, 111.1,
                                   ray_ops.camera_pose_deg(4.0, 30.0, -30.0),
                                   gen)


def nccl_rank(batch):
    import torch.distributed as dist
    out = nerf_rank(batch, 1)
    out["backend"] = dist.get_backend()
    return out


# -- phases ----------------------------------------------------------------

def check_nerf_dp(summary, n, backend, repeat):
    """25a: NeRF steps over n ranks against one process at the same
    weights; with ``repeat``, a second DP run must be bitwise equal."""
    from msra_practice_project_tpu_torch import dryrun
    from msra_practice_project_tpu_torch.parallel import mesh

    batch = lego_batch(NERF_RAYS)
    runs = [mesh.spawn(nerf_rank, n, args=(batch, NERF_STEPS),
                       backend=backend) for _ in range(2 if repeat else 1)]
    dp = runs[0][0]
    ref = dryrun.nerf_steps(batch, NERF_STEPS, nc=NC, nf=NF, device="cuda",
                            use_alpha=False, at=dp["before"])
    grad_err = [worst_rel(g, r) for g, r in zip(dp["grads"], ref["grads"])]
    loss_err = [abs(a - b) / abs(b) for a, b in zip(dp["loss"], ref["loss"])]
    print(f"  losses DP {dp['loss']}, one process {ref['loss']}", flush=True)
    print(f"  worst gradient error per step (relative Frobenius) {grad_err}",
          flush=True)
    check(max(grad_err) <= BF16_GATE, f"gradients within {BF16_GATE}")
    check(max(loss_err) <= LOSS_GATE, f"losses within {LOSS_GATE} relative")
    check(all(same(r["params"], dp["params"]) for r in runs[0]),
          "every rank ends with equal weights")
    if repeat:
        check(all(same(runs[1][r][k], runs[0][r][k]) for r in range(n)
                  for k in ("loss", "grads", "params")),
              "a second DP run repeats bitwise")
    counts = [(r["k1"], r["k2"]) for r in runs[0]]
    check(all(c == (2 * NERF_STEPS, 2 * NERF_STEPS) for c in counts),
          f"2 K1 and 2 K2 launches per step on each rank: {counts}")
    dp_ms = [float(np.mean(r["ms"][1:])) for r in runs[0]]
    print(f"  DP({n}, {backend}): {dp_ms} ms/step (steps 2-3, per rank; one "
          f"process at {NERF_RAYS} rays {float(np.mean(ref['ms'][1:])):.3f}, "
          "with the weight loads)", flush=True)
    summary["dp_nerf"] = {"ranks": n, "backend": backend,
                          "grad_rel_frob": grad_err, "loss_rel": loss_err,
                          "launches_per_rank": counts, "ms_per_step": dp_ms}


def check_pigan_dp(summary, n, backend):
    """25b: pi-GAN iterations over n ranks against one process at the same
    weights."""
    from msra_practice_project_tpu_torch import dryrun
    from msra_practice_project_tpu_torch.parallel import mesh

    dp_runs = mesh.spawn(pigan_rank, n, backend=backend)
    dp = dp_runs[0]
    ref = dryrun.pigan_steps(PIGAN_BATCH, stages=((PIGAN_RES, PIGAN_ITERS),),
                             z_dim=PIGAN_Z, samples=(8, 16), device="cuda",
                             at=dp["before"])
    d_err = [worst_rel(g, r) for g, r in zip(dp["d_grads"], ref["d_grads"])]
    g_err = [worst_rel(g, r) for g, r in zip(dp["g_grads"], ref["g_grads"])]
    loss_err = [abs(a - b) / abs(b) for k in ("d_loss", "g_loss")
                for a, b in zip(dp[k], ref[k])]
    print(f"  d_loss DP {dp['d_loss']} one process {ref['d_loss']}; g_loss "
          f"DP {dp['g_loss']} one process {ref['g_loss']}", flush=True)
    print(f"  worst gradient error per iteration: D {d_err}, G {g_err}",
          flush=True)
    check(max(d_err + g_err) <= BF16_GATE, f"D and G gradients within "
          f"{BF16_GATE}")
    check(max(loss_err) <= LOSS_GATE, f"losses within {LOSS_GATE} relative")
    check(all(same(r["params"], dp["params"]) for r in dp_runs),
          "every rank ends with equal weights")
    counts = [(r["k8_f32"], r["k8"], r["k7"]) for r in dp_runs]
    check(all(c == (4 * PIGAN_ITERS, 4 * PIGAN_ITERS, PIGAN_ITERS)
              for c in counts),
          f"4 K8 (fp32) and 1 K7 launches per iteration on each rank: "
          f"{counts}")
    dp_ms = [r["ms"][-1] for r in dp_runs]
    print(f"  DP({n}, {backend}): {dp_ms} ms/iteration (iteration 2, per "
          f"rank; one process {ref['ms'][-1]:.3f}, with its weight loads)",
          flush=True)
    summary["dp_pigan"] = {"ranks": n, "backend": backend,
                           "d_grad_rel_frob": d_err, "g_grad_rel_frob": g_err,
                           "loss_rel": loss_err, "launches_per_rank": counts,
                           "ms_per_iteration": dp_ms}


def phase_dp(summary):
    from msra_practice_project_tpu_torch.ops import rays as ray_ops
    from msra_practice_project_tpu_torch.ops.render import render_image
    from msra_practice_project_tpu_torch.parallel import mesh

    print("[phase] 25a: NeRF, 2 gloo ranks on one card, 3 lego-recipe steps "
          f"({NERF_RAYS // 2} rays a rank, {NC} + {NF} samples, K1/K2; not a "
          "scaling figure)", flush=True)
    check_nerf_dp(summary, 2, "gloo", repeat=True)
    print(f"[phase] 25b: pi-GAN, 2 gloo ranks, {PIGAN_ITERS} iterations at "
          f"test.json stage 0 in mode 1 ({PIGAN_BATCH // 2} latents a rank)",
          flush=True)
    check_pigan_dp(summary, 2, "gloo")

    print(f"[phase] 25c: a {VIEW}x{VIEW} eval view over 2 gloo ranks "
          "(render_view) against render_image", flush=True)
    views = mesh.spawn(view_rank, 2)
    models = view_models()
    gen = torch.Generator(device="cuda").manual_seed(5)
    want = render_image(VIEW, VIEW, 111.1,
                        ray_ops.camera_pose_deg(4.0, 30.0, -30.0), 2.0, 6.0,
                        *models, NC, NF, chunk=VIEW * VIEW // 2,
                        generator=gen, device="cuda")
    want = [t.cpu().numpy() for t in want]
    diff = max(float(np.abs(a - b).max()) for a, b in zip(views[0], want))
    check(all(np.array_equal(a, b) for v in views for a, b in zip(v, want)),
          f"every rank's view equals one process's render bitwise (max "
          f"|diff| {diff})")

    print("[phase] 25d: a one-rank NCCL group, one NeRF step", flush=True)
    batch = lego_batch(NERF_RAYS, seed=1)
    nccl = mesh.spawn(nccl_rank, 1, args=(batch,), backend="nccl")[0]
    ref = nerf_rank(batch, 1)
    check(nccl["backend"] == "nccl" and nccl["k1"] == 2 and nccl["k2"] == 2,
          f"NCCL group ran the step through K1/K2 ({nccl['backend']})")
    check(same(nccl["loss"], ref["loss"]) and same(nccl["grads"],
                                                   ref["grads"]),
          "its all-reduced step equals a process without a group bitwise")

    print("[phase] 25e: the package's dry run on the card, 2 gloo ranks",
          flush=True)
    from msra_practice_project_tpu_torch import dryrun
    try:
        lines = dryrun.dryrun_multichip(2, DEVICE)
    except AssertionError as e:
        lines = [f"failed: {e}"]
    check(len(lines) == 6, f"dryrun_multichip's OK lines: {len(lines)}")


def lego_config(out_dir, name, **kw):
    from msra_practice_project_tpu_torch.core.config import (
        CONFIG_ROOT, NERF_TRAIN_DEFAULTS, load_config, resolve)
    cfg = resolve(load_config(os.path.join(CONFIG_ROOT, "nerf", "lego.json")),
                  NERF_TRAIN_DEFAULTS)
    cfg.update({"output_path": out_dir, "experiment_name": name,
                "data_size": 400, "start_up_itrs": 5, "i_print": 10,
                "i_image": 1000, **kw})
    return cfg


def phase_resume(summary):
    from msra_practice_project_tpu_torch.train import train_nerf
    print("[phase] 26: exact resume, lego recipe: 20 steps against 10 + a "
          "resumed 10", flush=True)
    with tempfile.TemporaryDirectory(prefix="dp_check_") as out_dir:
        reset_counts()
        full = train_nerf.train(lego_config(out_dir, "full", iterations=20,
                                            i_save=20), DEVICE)
        counts = nerf_counts()
        train_nerf.train(lego_config(out_dir, "cut", iterations=10,
                                     i_save=10), DEVICE)
        res = train_nerf.train(lego_config(out_dir, "cut", iterations=20,
                                           i_save=10), DEVICE)
    check(counts == {"k1": 40, "k2": 40},
          f"2 K1 and 2 K2 launches per step: {counts}")
    print(f"  losses straight {full['log']['loss'][-3:]}, resumed "
          f"{res['log']['loss'][-3:]} (last 3)", flush=True)
    check(full["log"]["loss"] == res["log"]["loss"],
          "the 20 losses are equal bitwise")
    check(all(torch.equal(a, b)
              for m_a, m_b in zip(full["models"], res["models"])
              for a, b in zip(m_a.parameters(), m_b.parameters())),
          "the final weights are equal bitwise")
    summary["resume_losses_equal"] = True


@contextlib.contextmanager
def poisoned_buffer():
    """train_nerf's ray buffer with a NaN in the first row's origin."""
    from msra_practice_project_tpu_torch.train import train_nerf
    build = train_nerf.build_ray_buffer

    def poisoned(*args, **kwargs):
        buf = build(*args, **kwargs)
        buf[0, 0] = float("nan")
        return buf

    train_nerf.build_ray_buffer = poisoned
    try:
        yield
    finally:
        train_nerf.build_ray_buffer = build


def phase_diagnostics(summary):
    from msra_practice_project_tpu_torch.train import train_nerf
    print("[phase] 27: profile_steps (steps 11-12) and debug_nans, lego "
          "recipe", flush=True)
    with tempfile.TemporaryDirectory(prefix="dp_check_") as out_dir:
        train_nerf.train(lego_config(out_dir, "prof", iterations=14,
                                     i_save=1000, profile_steps=2), DEVICE)
        prof_dir = os.path.join(out_dir, "prof", "profile")
        traces = os.listdir(prof_dir)
        check(traces == ["trace_steps_11-12.json"], f"one trace: {traces}")
        with open(os.path.join(prof_dir, traces[0])) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
        found = {k: any(k in n for n in names) for k in KERNEL_NAMES}
        check(all(found.values()), f"the trace names K1's and K2's kernels: "
              f"{found} ({len(names)} kernel names)")
        out = train_nerf.train(lego_config(out_dir, "clean", iterations=3,
                                           i_save=1000, start_up_itrs=0,
                                           debug_nans=True), DEVICE)
        check(np.isfinite(out["log"]["loss"]).all(),
              "debug_nans is silent on a clean run through K1/K2")
        with poisoned_buffer():
            try:
                train_nerf.train(lego_config(out_dir, "nan", iterations=3,
                                             i_save=1000, start_up_itrs=0,
                                             debug_nans=True), DEVICE)
                raised = "nothing"
            except FloatingPointError as e:
                raised = f"FloatingPointError: {str(e)[:160]}"
        check(raised.startswith("FloatingPointError"),
              f"debug_nans on a poisoned batch raised {raised}")
    summary["profile_kernels"] = found


def phase_nccl(n):
    def run(summary):
        print(f"[phase] NCCL: NeRF, {n} ranks, one card each, 3 lego-recipe "
              f"steps ({NERF_RAYS // n} rays a rank)", flush=True)
        check_nerf_dp(summary, n, "nccl", repeat=False)
        print(f"[phase] NCCL: pi-GAN, {n} ranks, {PIGAN_ITERS} iterations "
              f"at test.json stage 0 ({PIGAN_BATCH // n} latents a rank)",
              flush=True)
        check_pigan_dp(summary, n, "nccl")
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_dp_check: CUDA is not available", file=sys.stderr)
        return 2
    _plain()
    from msra_practice_project_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    build.load_all(["nerf_mlp", "film_mlp"])   # before any rank loads them
    print(f"  kernels built or found ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"  {smi}", flush=True)
    summary = {"card": smi, "phase_seconds": {}}
    ok = True
    phases = (("25", phase_dp), ("26", phase_resume),
              ("27", phase_diagnostics))
    if "--nccl" in sys.argv:
        n = int(sys.argv[sys.argv.index("--nccl") + 1])
        if torch.cuda.device_count() < n:
            print(f"torch_dp_check: --nccl {n} needs {n} cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        phases = ((f"nccl{n}", phase_nccl(n)),)
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(summary)
        except CheckFailed:
            ok = False
        summary["phase_seconds"][name] = round(time.perf_counter() - t0, 1)
        print(f"  phase {name}: {summary['phase_seconds'][name]} s",
              flush=True)
        if not ok:
            break
    summary["ok"] = ok
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

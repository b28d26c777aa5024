"""Entry points of the port for a quick check: a single-device forward and a
multi-process data-parallel dry run (the port's counterpart of the JAX
package's ``__graft_entry__.py``).

entry()             -> (fn, example_args): the NeRF coarse+fine forward
                       render over a ray batch, on CUDA unless asked for
                       the CPU.
dryrun_multichip(n) -> spawns n gloo ranks, on the card unless asked for
                       the CPU; they run one data-parallel NeRF step, a
                       pi-GAN run across a stage switch, a sharded eval
                       render, and one SIREN image and one SDF step, each
                       checked, and rank 0's "OK" lines are printed.

The step drivers below (``nerf_steps``, ``pigan_steps``, ``siren_step``,
``sharded_views``, ``run_trainer``) run in one process or in every rank of
a group alike, so the tests and the card's checks spawn them to hold a
data-parallel run against one process.  Like every entry point of the port
they run on CUDA unless the caller passes ``device="cpu"``.

Run: python -m msra_practice_project_tpu_torch.dryrun [n] [--device cpu]
"""

from __future__ import annotations

import sys
import time

import torch

from . import resolve_device, set_plain_precision
from .parallel import mesh


def entry(device=None):
    """(fn, example_args): ``fn(coarse, fine, rays_o, rays_d, generator)``
    renders 256 rays with 32 + 64 samples through the full-width NeRF and
    returns the fine rgb ``[256, 3]``."""
    from .models.nerf import nerf_model
    from .ops import rays as ray_ops
    from .ops.render import render_rays

    device = resolve_device(device)
    init = torch.Generator().manual_seed(0)
    coarse = nerf_model(False, generator=init).to(device)
    fine = nerf_model(False, generator=init).to(device)
    pose = torch.as_tensor(ray_ops.camera_pose_deg(4.0, 20.0, -20.0),
                           dtype=torch.float32, device=device)
    ro, rd = ray_ops.get_rays_flat(16, 16, 18.0, pose)

    @torch.no_grad()
    def forward(coarse, fine, rays_o, rays_d, generator):
        return render_rays(rays_o, rays_d, 2.0, 6.0, coarse, fine, 32, 64,
                           generator=generator)["rgb_fine"]

    gen = torch.Generator(device=device).manual_seed(2)
    return forward, (coarse, fine, ro, rd, gen)


def _snapshot(*modules) -> list:
    return [p.detach().cpu().clone() for m in modules for p in m.parameters()]


def _load(modules, snap) -> None:
    with torch.no_grad():
        ps = [p for m in modules for p in m.parameters()]
        for p, s in zip(ps, snap):
            p.copy_(s)


def _grads(*modules) -> list:
    return [p.grad.detach().cpu().clone() for m in modules
            for p in m.parameters()]


NERF_CFG = {"use_fine_model": True, "use_alpha": True, "render_near": 2.0,
            "render_far": 6.0}


def nerf_steps(batch, steps: int = 2, seed: int = 0, nc: int = 4,
               nf: int = 8, device=None, at=None, jitter=None,
               use_alpha: bool = True) -> dict:
    """``steps`` NeRF train steps (``train_nerf.make_train_step``, the
    full-width PE NeRF from ``seed``; the fused kernels on CUDA) on the
    global ``batch`` [B, 10], step i's jitter from a generator seeded
    ``seed + 100 + i``.  ``at`` (a list of per-step parameter lists, as
    "before" returns them) loads those weights before each step, so a
    reference is computed at another run's weights; ``jitter`` (per-step
    ``[B, nc]``) replaces the generators' draws.  Returns the averaged
    losses, the averaged gradients after each step, the weights before
    each step, the final weights (all on the CPU) and each step's host
    milliseconds (it ends in a wait for the device)."""
    from .models.nerf import nerf_model
    from .train import common, train_nerf

    device = resolve_device(device)
    init = torch.Generator().manual_seed(seed)
    models = [nerf_model(False, generator=init).to(device) for _ in range(2)]
    params = [p for m in models for p in m.parameters()]
    opt = common.adam(params, common.exponential_lr(5e-4, 500))
    cfg = dict(NERF_CFG, render_coarse_sample_num=nc,
               render_fine_sample_num=nf, use_alpha=use_alpha)
    step = train_nerf.make_train_step(*models, opt, cfg, device)
    batch = batch.to(device)
    out = {"loss": [], "psnr": [], "grads": [], "before": [], "ms": []}
    for i in range(steps):
        if at is not None:
            _load(models, at[i])
        out["before"].append(_snapshot(*models))
        gen = torch.Generator(device=device).manual_seed(seed + 100 + i)
        t0 = time.perf_counter()
        m = step(batch, generator=gen,
                 jitter=None if jitter is None else jitter[i].to(device))
        out["loss"].append(float(m["loss"]))
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["psnr"].append(float(m["psnr"]))
        out["grads"].append(_grads(*models))
    out["params"] = _snapshot(*models)
    return out


def pigan_steps(batch: int, stages=((8, 2), (16, 2)), z_dim: int = 64,
                samples=(2, 4), seed: int = 0, device=None,
                diff_augment: str = "", instance_noise: bool = False,
                at=None) -> dict:
    """pi-GAN iterations (a D step, then a G step; ``make_gan_steps``)
    through ``stages`` of (resolution, iterations), the states carried
    across the switch with the fade-in at 0.5 in the stages after the
    first.  Real images, z and every draw come from generators seeded from
    (seed, iteration) for the global ``batch``.  ``at`` ({"d": [...], "g":
    [...]}, as "before" returns it) loads G's and D's weights before each D
    step and each G step.  Returns the averaged metrics and gradients per
    iteration, the weights before each step, the final weights and each
    iteration's host milliseconds (from its D step to the end of its G
    step, the copies of D's gradients and G's snapshot between them
    included; it ends in a wait for the device)."""
    from .models import pigan
    from .train import common, train_pigan

    device = resolve_device(device)
    init = torch.Generator().manual_seed(seed)
    nc, nf = samples
    g_model = pigan.Generator(pigan.GeneratorConfig(
        z_dim=z_dim, resolution=stages[0][0], coarse_samples=nc,
        fine_samples=nf), generator=init).to(device)
    d_model = pigan.Discriminator(generator=init).to(device)
    g_opt = common.adam(g_model.parameters(),
                        common.interp_lr(5e-5, 1e-5, 500), betas=(0.0, 0.9))
    d_opt = common.adam(d_model.parameters(),
                        common.interp_lr(4e-4, 1e-4, 500), betas=(0.0, 0.9))
    out = {"d_loss": [], "g_loss": [], "r1": [], "d_grads": [],
           "g_grads": [], "before": {"d": [], "g": []}, "ms": []}
    k = 0
    for s, (res, iters) in enumerate(stages):
        d_step, g_step = train_pigan.make_gan_steps(
            g_model, d_model, g_opt, d_opt, res, instance_noise=instance_noise,
            diff_augment_policy=diff_augment)
        alpha = -1.0 if s == 0 else 0.5
        for _ in range(iters):
            gen = torch.Generator(device=device).manual_seed(
                common.fold_seed(seed, k))
            real = torch.rand((batch, 3, res, res), generator=gen,
                              device=device)
            z = torch.randn((batch, z_dim), generator=gen, device=device)
            if at is not None:
                _load((g_model, d_model), at["d"][k])
            out["before"]["d"].append(_snapshot(g_model, d_model))
            t0 = time.perf_counter()
            m_d = d_step(real, z, alpha, 0.05, generator=gen)
            out["d_grads"].append(_grads(d_model))
            z = torch.randn((batch, z_dim), generator=gen, device=device)
            if at is not None:
                _load((g_model, d_model), at["g"][k])
            out["before"]["g"].append(_snapshot(g_model, d_model))
            m_g = g_step(z, alpha, 0.05, generator=gen)
            out["g_grads"].append(_grads(g_model))
            for key, v in (("d_loss", m_d["d_loss"]), ("r1", m_d["r1"]),
                           ("g_loss", m_g["g_loss"])):
                out[key].append(float(v))
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            k += 1
    out["params"] = _snapshot(g_model, d_model)
    out["count"] = (g_opt.count, d_opt.count)
    return out


def siren_step(kind: str, batch: int = 64, seed: int = 0,
               device=None) -> dict:
    """One SIREN train step of ``kind`` ("img" or "sdf") on a global batch
    drawn from ``seed`` (the SDF's off-surface points too).  Returns the
    averaged loss, the averaged gradients and the updated weights."""
    from .models.siren_mlp import img_model, sdf_model
    from .train import common, train_img, train_sdf

    device = resolve_device(device)
    init = torch.Generator().manual_seed(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    if kind == "img":
        model = img_model("siren", generator=init).to(device)
        opt = common.adam(list(model.parameters()), 1e-4)
        data = (torch.rand((batch, 3), generator=gen) * 2 - 1,)
        step = train_img.make_train_step(model, opt)
    else:
        model = sdf_model("siren", generator=init).to(device)
        opt = common.adam(list(model.parameters()), 1e-4)
        normals = torch.randn((batch, 3), generator=gen)
        data = (torch.cat([torch.rand((batch, 3), generator=gen) * 2 - 1,
                           normals / normals.norm(dim=-1, keepdim=True)], 1),
                torch.rand((batch, 3), generator=gen) * 2 - 1)
        step = train_sdf.make_train_step(model, opt)
    m = step(*(d.to(device) for d in data))
    return {"loss": float(m["loss"]), "grads": _grads(model),
            "params": _snapshot(model)}


def sharded_views(width: int, height: int, chunk: int, cases,
                  device=None) -> list:
    """Views through ``render_image_sharded`` (the tiles split over the
    ranks), one per case ``(model, perturb, nc, nf, seed)``: ``model`` draws
    (coarse and fine alike) with the jitter from a generator seeded
    ``seed``.  Returns [(rgb, depth, acc) on the CPU]."""
    from .ops import rays as ray_ops
    from .ops.render import render_image_sharded

    device = resolve_device(device)
    pose = ray_ops.camera_pose_deg(4.0, 30.0, -30.0)
    out = []
    for model, perturb, nc, nf, seed in cases:
        model = model.to(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        views = render_image_sharded(
            width, height, 18.0, pose, 2.0, 6.0, model, model, nc, nf,
            chunk=chunk, perturb=perturb, generator=gen, device=device)
        out.append(tuple(t.cpu() for t in views))
    return out


def run_trainer(name: str, config: dict, device=None) -> dict:
    """``train.<name>.train`` on a resolved config (on CUDA unless
    ``device='cpu'``); returns its loss log."""
    import importlib

    mod = importlib.import_module(f"{__package__}.train.{name}")
    out = mod.train(config, device=device)
    return out["loss_log"] if name == "train_pigan" else out["log"]


def _check_replicas(params, what) -> None:
    """Every rank holds rank 0's weights."""
    flat = torch.cat([p.reshape(-1) for p in params])
    first = flat.clone()
    torch.distributed.broadcast(first, 0)
    if not torch.equal(first, flat):
        raise AssertionError(f"{what}: the replicas differ")


VIEW_KW = dict(near=2.0, far=6.0, coarse_sample_num=4, fine_sample_num=8,
               chunk=32, perturb=False)


def _view(device):
    """The dry run's 16x16 view: a full-width NeRF as coarse and fine
    model, one tile of 32 rays a rank on two ranks."""
    from .models.nerf import nerf_model
    from .ops import rays as ray_ops
    from .ops.render import render_image

    set_plain_precision()
    model = nerf_model(False, generator=torch.Generator().manual_seed(3))
    model = model.to(device)
    pose = ray_ops.camera_pose_deg(4.0, 20.0, -20.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as in every rank: CPU sums round by it
    try:
        return tuple(t.cpu() for t in render_image(
            16, 16, 18.0, pose, coarse_fn=model, fine_fn=model,
            device=device, **VIEW_KW))
    finally:
        torch.set_num_threads(threads)


def _dryrun_rank(n: int, device) -> tuple:
    """One rank of ``dryrun_multichip``: every check, the OK lines, and the
    sharded view, which the caller holds against one process."""
    import numpy as np

    lines = []
    gen = torch.Generator().manual_seed(2)
    batch = torch.rand((8 * n, 10), generator=gen)
    out = nerf_steps(batch, steps=1, nc=8, nf=16, device=device)
    if not np.isfinite(out["loss"][0]):
        raise AssertionError(f"non-finite NeRF loss {out['loss']}")
    if all(torch.equal(a, b) for a, b in zip(out["before"][0],
                                             out["params"])):
        raise AssertionError("the NeRF step was a no-op")
    _check_replicas(out["params"], "nerf")
    lines.append(f"dryrun_multichip OK (nerf): {n} ranks, batch {8 * n}, "
                 f"loss {out['loss'][0]:.4f}")

    out = pigan_steps(2 * n, stages=((8, 1), (16, 1)), device=device)
    losses = out["d_loss"] + out["g_loss"]
    if not np.isfinite(losses).all() or out["count"] != (2, 2):
        raise AssertionError(f"pi-GAN: losses {losses}, counts "
                             f"{out['count']}")
    _check_replicas(out["params"], "pigan")
    lines.append(f"dryrun_multichip OK (pigan): {n} ranks, batch {2 * n}, "
                 f"d_loss {out['d_loss'][0]:.4f} g_loss "
                 f"{out['g_loss'][0]:.4f}")
    lines.append(f"dryrun_multichip OK (pigan stage switch): 8^2 -> 16^2 "
                 f"with fade-in 0.5, states carried, d_loss "
                 f"{out['d_loss'][1]:.4f} g_loss {out['g_loss'][1]:.4f}")

    view = _view(device)

    for kind in ("img", "sdf"):
        out = siren_step(kind, batch=8 * n, device=device)
        if not np.isfinite(out["loss"]):
            raise AssertionError(f"siren {kind}: loss {out['loss']}")
        _check_replicas(out["params"], f"siren {kind}")
        lines.append(f"dryrun_multichip OK (siren {kind} DP): batch "
                     f"{8 * n}, loss {out['loss']:.4f}, replicas equal")
    return lines, view


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Spawn ``n_devices`` gloo ranks on ``device`` (the card unless the
    caller asks for the CPU; the ranks share it), run every data-parallel
    path in them, hold the sharded view against one process's render, print
    rank 0's OK lines and return them; raises if a rank or a check
    fails."""
    device = resolve_device(device)
    runs = mesh.spawn(_dryrun_rank, n_devices, args=(n_devices, str(device)))
    want = _view(device)
    if not all(torch.equal(a, b) for _, view in runs
               for a, b in zip(view, want)):
        raise AssertionError("the sharded render differs from one process")
    lines = runs[0][0]
    lines.insert(3, f"dryrun_multichip OK (sharded render_image): 16x16 "
                    f"frame over {n_devices} ranks == one process")
    for line in lines:
        print(line, flush=True)
    return lines


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = None
    if "--device" in args:
        i = args.index("--device")
        dev = args[i + 1]
        del args[i:i + 2]
    if resolve_device(dev).type == "cuda":
        fn, fn_args = entry()
        out = fn(*fn_args)
        print("entry OK:", tuple(out.shape), float(out.mean()))
    dryrun_multichip(int(args[0]) if args else 2, dev)

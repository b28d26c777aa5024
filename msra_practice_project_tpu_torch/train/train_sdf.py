"""SIREN SDF fitting from an oriented point cloud, and mesh extraction (port
of ``msra_practice_project_tpu/train/train_sdf.py``, ref: siren/train_sdf.py
+ siren/utils_sdf.py).

Loss (ref: siren/utils_sdf.py:14-21):
  3e3 * mean(f_on^2) + 1e2 * mean(exp(-100 |f_off|))
  + 5e1 * mean((||grad f|| - 1)^2)  [on+off concat]
  + 1e2 * mean(1 - cos(grad f_on, normal))
The input gradients come from ``torch.autograd.grad(create_graph=True)``,
so the parameter gradient differentiates through them (the reference's
double autograd, siren/train_sdf.py:73-76).

  * Off-surface points: U(-1, 1) from a generator seeded per step from
    (seed + 1, step); the JAX package folds the step into a key, a stream
    torch cannot replay, so tests inject ``off_point``.
  * The cloud is permuted before the first epoch and at every epoch
    boundary with ``torch.randperm`` seeded from (seed + 2, epoch): the
    intended behaviour of siren/train_sdf.py:70-71, whose reshuffle is dead
    code.  A resumed run restarts this stream, as the JAX trainer does.
  * Meshes: the SDF on an n^3 grid, one x-slice per call on the device,
    then marching tetrahedra on the host (``core/mesh``) and a PLY; every
    ``i_mesh`` steps at ``mesh_n`` (128) and at the end at
    ``final_mesh_n`` (512, ref: siren/train_sdf.py:101).
  * The MLP is plain PyTorch on either device, in strict fp32.

  * Data parallelism under ``torchrun`` (``parallel/mesh.py``): the model
    and Adam replicate, every rank keeps the whole buffer (the JAX package
    row-shards it over its chips to save HBM) and the same stream, and
    takes its block of each global batch (and of its off-surface points, drawn whole on every rank); gradients and the loss are
    averaged in one all-reduce per step.  The batch must divide over the
    ranks.  Rank 0 writes the logs, meshes and checkpoints.
  * Resumes from the port's checkpoints or a JAX run's (``core/ckpt``,
    ``weights.train_state_from_jax``).
  * ``profile_steps``, ``debug_nans`` and ``watchdog_timeout``
    (``core/diagnostics.py``).

Run: python -m msra_practice_project_tpu_torch.train.train_sdf <config.json>
     torchrun --nproc_per_node=N -m msra_practice_project_tpu_torch.train.\
train_sdf <config.json> [--device cpu --backend gloo]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import resolve_device, set_plain_precision
from ..core import ckpt as ckpt_lib
from ..core import mesh as mesh_lib
from ..core.config import SIREN_SDF_DEFAULTS, log_dir, save_config
from ..core import diagnostics
from ..core.logging import MetricLogger, log_print
from ..data.pointcloud import load_point_cloud, make_synthetic_sphere_cloud
from ..models.siren_mlp import sdf_model
from ..parallel import mesh
from . import common

LOSS_WEIGHTS = (3e3, 1e2, 5e1, 1e2)


def sdf_loss(model, on_point, on_norm, off_point) -> torch.Tensor:
    """The 4-term SIREN SDF loss with input-gradient terms.  One forward
    over ``[on; off]``: the rows are independent, so the gradient of the
    sum is each point's input gradient."""
    n_on = on_point.shape[0]
    pts = torch.cat([on_point, off_point], dim=0).detach().requires_grad_()
    pred = model(pts)
    (grad,) = torch.autograd.grad(pred.sum(), pts, create_graph=True)
    on_pred, off_pred = pred[:n_on], pred[n_on:]
    on_grad = grad[:n_on]

    on_loss = torch.mean(on_pred ** 2)
    off_loss = torch.mean(torch.exp(-1e2 * torch.abs(off_pred)))
    grad_loss = torch.mean((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2)
    cos = torch.sum(on_grad * on_norm, -1) / (
        torch.linalg.norm(on_grad, dim=-1)
        * torch.linalg.norm(on_norm, dim=-1) + 1e-9)
    normal_loss = torch.mean(1.0 - cos)
    k = LOSS_WEIGHTS
    return (k[0] * on_loss + k[1] * off_loss + k[2] * grad_loss
            + k[3] * normal_loss)


def off_surface_points(n: int, seed: int, step: int,
                       device) -> torch.Tensor:
    """``[n, 3]`` U(-1, 1) for step ``step`` (1-based), from (seed + 1,
    step)."""
    gen = torch.Generator(device=device).manual_seed(
        common.fold_seed(seed + 1, step))
    return torch.rand((n, 3), generator=gen, device=device) * 2.0 - 1.0


def shuffled(cloud: torch.Tensor, seed: int, epoch: int) -> torch.Tensor:
    """The cloud's rows permuted for ``epoch``, from (seed + 2, epoch)."""
    gen = torch.Generator(device=cloud.device).manual_seed(
        common.fold_seed(seed + 2, epoch))
    return cloud[torch.randperm(cloud.shape[0], generator=gen,
                                device=cloud.device)]


def make_train_step(model, opt):
    """Returns step(batch [B, 6], off_point [B, 3]) -> {"loss"}, which
    updates the model in place.  Under data parallelism both are the
    global batch: each rank takes its block of each, and the gradients and
    the loss are averaged over the ranks before Adam."""
    params = list(model.parameters())

    def step(batch, off_point):
        batch, off_point = mesh.local_slice(batch), mesh.local_slice(off_point)
        loss = sdf_loss(model, batch[:, :3], batch[:, 3:], off_point)
        opt.zero_grad()
        loss.backward()
        (loss,) = mesh.all_reduce_grads(params, loss.detach())
        opt.step()
        return {"loss": loss}

    return step


def _sdf_slice(model, x: float, n: int, bound: float = 1.0) -> torch.Tensor:
    """One x-slice of the n^3 grid: ``[n, n]`` SDF values."""
    dev = next(model.parameters()).device
    grid = torch.linspace(-bound, bound, n, device=dev)
    yy, zz = torch.meshgrid(grid, grid, indexing="ij")
    pts = torch.stack([torch.full_like(yy, x), yy, zz], dim=-1)
    return model(pts.reshape(-1, 3)).reshape(n, n)


def sdf_grid(model, n: int, bound: float = 1.0, watchdog=None) -> np.ndarray:
    """The SDF on the n^3 grid over [-bound, bound]^3, ``[x, y, z]``: one
    x-slice per call on the device, one copy to the host at the end; the
    watchdog is beaten per slice."""
    dev = next(model.parameters()).device
    values = torch.empty((n, n, n), device=dev)
    with torch.no_grad():
        for i, x in enumerate(np.linspace(-bound, bound, n)):
            if watchdog is not None:
                watchdog.beat(f"mesh slice {i}/{n}")
            values[i] = _sdf_slice(model, float(np.float32(x)), n, bound)
    return values.cpu().numpy()


def create_mesh(model, filename: str, n: int = 256, level: float = 0.0,
                bound: float = 1.0, watchdog=None):
    """Dense-grid eval -> marching tetrahedra -> ``filename + ".ply"``
    (ref: siren/utils_sdf.py:25-83).  The watchdog is paused for the host's
    marching pass, which can outlast its timeout on large grids.  Returns
    (values, verts, faces)."""
    values = sdf_grid(model, n, bound, watchdog)
    voxel_size = 2.0 * bound / (n - 1)
    if watchdog is not None:
        watchdog.pause()
    try:
        verts, faces = mesh_lib.extract_mesh_from_grid(
            values, level, (-bound,) * 3, voxel_size, filename + ".ply")
    finally:
        if watchdog is not None:
            watchdog.resume()
    return values, verts, faces


def load_cloud(config) -> np.ndarray:
    """The configured ``[N, 6]`` cloud, or a synthetic sphere (radius 0.6,
    ``data_points`` points) when the file does not exist."""
    data_path = config.get("data_path", "")
    if data_path and os.path.exists(data_path):
        return load_point_cloud(data_path)
    log_print(f"[data] {data_path!r} not found - using synthetic sphere "
              "point cloud")
    return make_synthetic_sphere_cloud(config.get("data_points", 100000))


def train(config, device=None, timed_steps=0, window=None) -> dict:
    """Train from a resolved config; runs on CUDA unless ``device='cpu'``.

    With ``timed_steps`` > 0 the last that many steps are one timed window
    (``common.TimedWindow``), with ``window`` entered for them; the final
    mesh comes after it.  Returns the state, the metric log, the model and
    ``window_ms`` (None when the window did not run)."""
    device = resolve_device(device)
    set_plain_precision()
    log_path = log_dir(config)
    os.makedirs(log_path, exist_ok=True)
    main = mesh.is_main()
    if main:
        save_config(config, log_path)
    profiler = common.step_profiler(config, log_path, device, window)

    seed = config.get("seed", 0)
    cloud = torch.from_numpy(load_cloud(config)).to(device)
    n = cloud.shape[0]
    batch_size = min(config["batch_size"], n)

    gen = torch.Generator().manual_seed(seed)
    model = sdf_model(config["model_type"], generator=gen).to(device)
    opt = common.adam(list(model.parameters()), config["learning_rate"])
    state = common.init_state({"model": model}, opt)
    global_step, state = common.resume(log_path, state, "sdf")
    mesh.broadcast_state(model)
    if mesh.world() > 1:
        mesh.check_divides("batch_size", batch_size)
        if main:
            log_print(f"[parallel] data-parallel over {mesh.world()} ranks")
    step_fn = make_train_step(model, opt)

    logger = MetricLogger(["loss"])
    log_file = os.path.join(log_path, "log.npy")
    if global_step and os.path.exists(log_file):
        # the merged log spans the whole run across restarts
        logger.preload(MetricLogger.load(log_file), global_step)

    batch_idx, epoch_idx = 0, 0
    cloud = shuffled(cloud, seed, epoch_idx)
    i_mesh = config.get("i_mesh", 1000)
    mesh_n = config.get("mesh_n", 128)
    iterations = config["iterations"]
    with diagnostics.enable_from_config(config) as nans, \
            diagnostics.watchdog_from_config(config, log_path) as watchdog, \
            common.TimedWindow(device, iterations, timed_steps,
                               window) as timer:
        while global_step < iterations:
            timer.before_step(global_step)
            profiler.tick(global_step + 1)
            watchdog.beat(f"step {global_step}")
            lo = batch_idx * batch_size
            m = step_fn(cloud[lo:lo + batch_size],
                        off_surface_points(batch_size, seed,
                                           global_step + 1, device))
            nans.check(global_step + 1, loss=m["loss"])
            logger.append(loss=m["loss"])
            batch_idx += 1
            global_step += 1
            state["step"] = global_step
            if (batch_idx + 1) * batch_size > n:
                batch_idx = 0
                epoch_idx += 1
                cloud = shuffled(cloud, seed, epoch_idx)
            timer.after_step(global_step)

            if global_step % config["i_print"] == 0 and main:
                log_print(f"[Train] Iter: {global_step}({epoch_idx}-"
                          f"{batch_idx}) Loss: {float(m['loss'])}")
            if global_step % i_mesh == 0 and main:
                create_mesh(model, os.path.join(log_path,
                                                f"{global_step:06d}"),
                            n=mesh_n, watchdog=watchdog)
            if global_step % config["i_save"] == 0 and main:
                # log before ckpt: resume truncates a log that ran ahead
                logger.save(log_path)
                p = ckpt_lib.save(log_path, global_step,
                                  common.state_dict(state))
                log_print(f"Saved checkpoints at {p}")

        profiler.stop()
        log = logger.data
        if main:
            logger.save(log_path)
            # the final mesh (ref: siren/train_sdf.py:101, n 512); its
            # slices stay under the watchdog, the host's marching pass
            # pauses it
            create_mesh(model, os.path.join(log_path, "test"),
                        n=config.get("final_mesh_n", 512), watchdog=watchdog)
    return {"state": state, "log": log, "model": model,
            "window_ms": timer.ms()}


def main(argv=None):
    argv, device = common.launch(argv if argv is not None else sys.argv[1:])
    config = common.parse_cli(argv, SIREN_SDF_DEFAULTS)
    train(config, device)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""End-to-end SDF quality gate for the PyTorch/CUDA port (the counterpart of
tools/validate_sdf.py): fit a known shape, measure the mesh.

Trains the SIREN SDF pipeline (``train_sdf.train``) on an analytic sphere
point cloud (radius 0.6, 60,000 points, batch 8,192) and checks the
extracted isosurface (n 128) against ground truth: the mean |r - 0.6| must
be under one voxel and its 95th percentile under three.  ``--real`` fits
the USGS Jacksboro Fault DEM (the port's copy of matplotlib's sample file,
data/sample_data/), closed into a solid block, through the ``.npz`` data
path, and gates the top surface's |z - DEM| the same way.  Exit code 1 when
a gate fails.

Run: python3 tools/torch_validate_sdf.py [iterations] [--real]
         [--device cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from msra_practice_project_tpu_torch.core.config import (  # noqa: E402
    SIREN_SDF_DEFAULTS, resolve)
from msra_practice_project_tpu_torch.core.mesh import read_ply  # noqa: E402
from msra_practice_project_tpu_torch.train import train_sdf  # noqa: E402

RADIUS = 0.6
MESH_N = 128
VOXEL = 2.0 / (MESH_N - 1)
EXTENT, Z_BOTTOM = 0.7, -0.35   # the DEM block


def _base(out_dir):
    return out_dir or os.path.join(tempfile.gettempdir(),
                                   "sdf_validate_torch")


def _train(base, exp, iterations, device, overrides, **cfg):
    # a fresh run every time: a checkpoint at `iterations` would resume into
    # a 0-step no-op and validate the previous run
    shutil.rmtree(os.path.join(base, exp), ignore_errors=True)
    cfg = resolve({
        "output_path": base, "experiment_name": exp,
        "iterations": iterations, "batch_size": 8192, "model_type": "siren",
        "i_print": max(iterations // 8, 1), "i_save": iterations,
        "i_mesh": iterations, "mesh_n": MESH_N, "final_mesh_n": MESH_N,
        **cfg, **(overrides or {}),
    }, SIREN_SDF_DEFAULTS)
    out = train_sdf.train(cfg, device=device, timed_steps=iterations)
    losses = out["log"]["loss"]
    print(f"[validate] loss {losses[0]:.1f} -> "
          f"{np.mean(losses[-50:]):.2f}", flush=True)
    log_path = os.path.join(base, exp)
    verts, faces = read_ply(os.path.join(log_path, "test.ply"))
    return {"log_path": log_path, "loss_first": float(losses[0]),
            "loss_last50": float(np.mean(losses[-50:])),
            "ms_per_step": out["window_ms"] / iterations,
            "verts": int(verts.shape[0]), "faces": int(faces.shape[0])}, \
        verts


def error_stats(err: np.ndarray) -> tuple[float, float]:
    """(mean, 95th percentile) of the errors; NaN for an empty mesh."""
    if err.size == 0:
        return float("nan"), float("nan")
    return float(err.mean()), float(np.percentile(err, 95))


def main(iterations=4000, device=None, out_dir=None, overrides=None) -> dict:
    """The sphere gate.  Returns the run's readings with "ok", "mean_err",
    "p95_err", "voxel" and "radius"; ``overrides`` replaces keys of the
    training config (smaller runs)."""
    res, verts = _train(_base(out_dir), "exp", iterations, device,
                        overrides, data_path="", data_points=60000)
    r = np.linalg.norm(verts, axis=-1)
    res["mean_err"], res["p95_err"] = error_stats(np.abs(r - RADIUS))
    res["radius"] = float(r.mean()) if r.size else float("nan")
    res["voxel"] = VOXEL
    print(f"[validate] mesh: {res['verts']} verts, {res['faces']} faces")
    print(f"[validate] radius {res['radius']:.4f} (target {RADIUS}), "
          f"mean |err| {res['mean_err']:.4f}, p95 {res['p95_err']:.4f}, "
          f"voxel {VOXEL:.4f}")
    res["ok"] = bool(res["mean_err"] < VOXEL and res["p95_err"] < 3 * VOXEL)
    print("[validate]", "PASS" if res["ok"] else "FAIL",
          "(mean error < 1 voxel, p95 < 3 voxels)", flush=True)
    return res


def dem_surface_error(verts: np.ndarray) -> np.ndarray:
    """|z - DEM| of the mesh vertices on the block's top surface: inside
    0.9 of the footprint and above the bottom face."""
    from scipy.interpolate import RegularGridInterpolator

    from msra_practice_project_tpu_torch.data.pointcloud import (
        load_dem_heightfield)

    height, x_lin, y_lin = load_dem_heightfield(EXTENT)
    interp = RegularGridInterpolator((y_lin, x_lin), height)
    inside = (np.abs(verts[:, 0]) <= 0.9 * EXTENT) & \
        (np.abs(verts[:, 1]) <= 0.9 * EXTENT) & \
        (verts[:, 2] >= Z_BOTTOM + 0.07)
    v = verts[inside]
    if not v.size:
        return np.zeros(0)
    return np.abs(v[:, 2] - interp(np.stack([v[:, 1], v[:, 0]], axis=1)))


def main_real(iterations=4000, device=None, out_dir=None,
              overrides=None) -> dict:
    """The real-terrain gate: the DEM closed into a watertight block (an
    open sheet is ill-posed for an SDF: the field must re-cross zero around
    its boundary), written as an ``.npz`` cloud and read through
    ``data_path``; the top surface inside 0.9 of the footprint and above
    the bottom face is gated against the heightfield."""
    from msra_practice_project_tpu_torch.data.pointcloud import (
        make_dem_cloud)

    base = _base(out_dir)
    os.makedirs(base, exist_ok=True)
    cloud = make_dem_cloud(n=100000, extent=EXTENT, closed=True,
                           z_bottom=Z_BOTTOM)
    cloud_path = os.path.join(base, "dem_cloud.npz")
    np.savez(cloud_path, p=cloud)
    print(f"[validate] real-terrain cloud: {cloud.shape[0]} oriented points "
          f"from the Jacksboro Fault DEM, closed into a solid block (skirt "
          f"sides + bottom at z={Z_BOTTOM})")
    res, verts = _train(base, "dem", iterations, device, overrides,
                        data_path=cloud_path)

    err = dem_surface_error(verts)
    res["mean_err"], res["p95_err"] = error_stats(err)
    res["in_region"], res["voxel"] = int(err.size), VOXEL
    print(f"[validate] mesh: {res['verts']} verts ({err.size} in-region),"
          f" {res['faces']} faces")
    print(f"[validate] |z - DEM|: mean {res['mean_err']:.4f}, "
          f"p95 {res['p95_err']:.4f}, voxel {VOXEL:.4f}")
    res["ok"] = bool(err.size > 5000 and res["mean_err"] < VOXEL
                     and res["p95_err"] < 3 * VOXEL)
    print("[validate]", "PASS" if res["ok"] else "FAIL",
          "(real-terrain surface recovered to <1 voxel mean, <3 voxel p95)",
          flush=True)
    return res


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("iterations", nargs="?", type=int, default=4000)
    p.add_argument("--real", action="store_true",
                   help="fit the Jacksboro Fault DEM (data/sample_data/)")
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: CUDA)")
    p.add_argument("--out", default=None,
                   help="directory for the experiment "
                        "(default: <tmp>/sdf_validate_torch)")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args(sys.argv[1:])
    entry = main_real if a.real else main
    sys.exit(0 if entry(a.iterations, a.device, a.out)["ok"] else 1)

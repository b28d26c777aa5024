#!/usr/bin/env python3
"""Final-mesh sizes of a briefly trained SDF, for choosing ``final_mesh_n``.

Trains ``train_sdf.train`` at ``configs/siren/<kind>_sdf_1.json``'s recipe
(65,536 + 65,536 points a step) on the synthetic sphere for ``--steps``
steps, as ``chip_smoke.py``'s SDF phase does, then meshes the model at
each ``--n`` in turn: the SDF grid on the device, then the host's marching
and the PLY.  Prints one JSON line per n with the grid and marching
seconds, the vertex and face counts and the process's peak host memory,
and stops before the next n once a mesh passes ``--max-verts`` vertices.

Run: python3 tools/torch_sdf_mesh_sizes.py [--kind relu_pe]
         [--n 128 256 512] [--steps 55] [--max-verts 30000000]
         [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from msra_practice_project_tpu_torch.core import mesh as mesh_lib  # noqa: E402
from msra_practice_project_tpu_torch.core.config import (  # noqa: E402
    CONFIG_ROOT, SIREN_SDF_DEFAULTS, load_config, resolve)
from msra_practice_project_tpu_torch.train import train_sdf  # noqa: E402


def mesh_sizes(kind="relu_pe", ns=(128, 256, 512), steps=55,
               max_verts=30_000_000, device=None, overrides=None) -> list:
    """One dict per n meshed (n, grid_seconds, marching_seconds, verts,
    faces, host_maxrss_gib); ``overrides`` replace config keys."""
    rows = []
    with tempfile.TemporaryDirectory(prefix="sdf_mesh_sizes_") as tmp:
        cfg = resolve(load_config(os.path.join(
            CONFIG_ROOT, "siren", f"{kind}_sdf_1.json")), SIREN_SDF_DEFAULTS)
        cfg.update(output_path=tmp, experiment_name=kind, data_path="",
                   iterations=steps, i_print=steps, i_save=steps,
                   i_mesh=10 ** 9, final_mesh_n=8, **(overrides or {}))
        model = train_sdf.train(cfg, device=device)["model"]
        for n in ns:
            t0 = time.perf_counter()
            values = train_sdf.sdf_grid(model, n)
            t1 = time.perf_counter()
            verts, faces = mesh_lib.extract_mesh_from_grid(
                values, 0.0, (-1.0,) * 3, 2.0 / (n - 1),
                os.path.join(tmp, f"mesh_{n}.ply"))
            t2 = time.perf_counter()
            rows.append({
                "kind": kind, "steps": steps, "n": n,
                "grid_seconds": t1 - t0, "marching_seconds": t2 - t1,
                "verts": int(verts.shape[0]), "faces": int(faces.shape[0]),
                "host_maxrss_gib":
                    resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                    / 2 ** 20})
            print(json.dumps(rows[-1]), flush=True)
            del values, verts, faces
            if rows[-1]["verts"] > max_verts:
                break
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", default="relu_pe")
    ap.add_argument("--n", type=int, nargs="+", default=[128, 256, 512])
    ap.add_argument("--steps", type=int, default=55)
    ap.add_argument("--max-verts", type=int, default=30_000_000)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    mesh_sizes(args.kind, args.n, args.steps, args.max_verts, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

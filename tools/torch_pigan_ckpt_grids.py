#!/usr/bin/env python3
"""Per-checkpoint sample grids of a pi-GAN run, for the PyTorch/CUDA port
(the counterpart of tools/pigan_ckpt_grids.py).

Renders the same 8 latents (at the frontal pose) at every saved checkpoint
of an experiment directory and stacks the rows in time order into
``ckpt_evolution.png``, so the moment structure appears, or collapses, is
visible at a glance.  tools/torch_validate_pigan.py writes the same
artifact inline; this tool makes it for finished or foreign runs: the
port's own and the JAX package's (flax msgpack checkpoints, read through
``weights.restore_state``).  It also prints each checkpoint's diversity,
low-frequency structure and center-corner head contrast against the run's
own dataset when the run holds one (``_synthetic_faces``).

z comes from a seeded torch generator: JAX keys cannot be replayed, so the
grid of a JAX run is the port's rendering of that run's weights.  On CUDA
the trunk runs in the mode ``MSRA_TPU_FUSED_FILM`` picks (1 when unset: K8
in fp32; no backward, so no K7).  The last line is a JSON object of the
readings.

Run: python3 tools/torch_pigan_ckpt_grids.py <experiment_dir> [resolution]
         [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from msra_practice_project_tpu_torch import (  # noqa: E402
    resolve_device, weights)
from msra_practice_project_tpu_torch.core import ckpt as ckpt_lib  # noqa: E402
from msra_practice_project_tpu_torch.core import image_io  # noqa: E402
from msra_practice_project_tpu_torch.core.config import (  # noqa: E402
    PIGAN_TRAIN_DEFAULTS, load_config, resolve)
from msra_practice_project_tpu_torch.eval.pigan_demo import (  # noqa: E402
    _grid, load_generator)
from msra_practice_project_tpu_torch.train.common import (  # noqa: E402
    fold_seed)

Z_SEED, N_LATENTS = 7, 8


@torch.no_grad()
def main(exp: str, res: int = 64, device=None) -> dict:
    """Writes ``<exp>/ckpt_evolution.png``; returns the checkpoint steps,
    each one's readings and the image's path (None without checkpoints)."""
    from msra_practice_project_tpu_torch.data.image_folder import ImageFolder
    from tools.torch_validate_pigan import (center_corner_contrast,
                                            lowfreq_spatial_std)

    device = resolve_device(device)
    exp = os.path.abspath(exp)
    config = resolve(load_config(os.path.join(exp, "config.json")),
                     PIGAN_TRAIN_DEFAULTS)
    config["output_path"] = os.path.dirname(exp)
    config["experiment_name"] = os.path.basename(exp)
    generator, _, _ = load_generator(config, device)
    dev = next(generator.parameters()).device

    z = torch.randn(N_LATENTS, generator.cfg.z_dim, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(Z_SEED))
    theta = torch.zeros(N_LATENTS, device=dev)
    phi = torch.zeros(N_LATENTS, device=dev)

    # the dataset's reference values for the structure metrics, if present
    data_dir = os.path.join(exp, "_synthetic_faces")
    lf_real = cc_real = None
    if os.path.isdir(data_dir):
        _, _, real = ImageFolder(data_dir, 64, resize=res / 64.0,
                                 device=dev).get()
        real = real.cpu().numpy()
        lf_real = lowfreq_spatial_std(real)
        cc_real = center_corner_contrast(real)
        print(f"real @{res}: lowfreq {lf_real:.4f}  "
              f"center-corner {cc_real:.4f}")

    steps = [s for s, _ in ckpt_lib.list_checkpoints(exp)]
    out = {"exp": exp, "resolution": res, "steps": steps, "ckpts": [],
           "lowfreq_real": lf_real, "center_corner_real": cc_real,
           "out": None}
    if not steps:
        print(f"no checkpoints under {exp} yet")
        return out
    rows = []
    for s in steps:
        saved = weights.restore_state(
            ckpt_lib.restore(ckpt_lib.ckpt_path(exp, s), map_location=dev),
            "pigan")
        generator.load_state_dict(saved["g"])
        film = generator.get_mapping(z)
        imgs = generator.render_film(
            film, theta, phi, resolution=res,
            generator=torch.Generator(device=dev).manual_seed(
                fold_seed(Z_SEED, s))).cpu().numpy()
        rows.append(imgs)
        r = {"step": s, "min": float(imgs.min()), "max": float(imgs.max()),
             "div": float(imgs.std(axis=0).mean()),
             "lowfreq": lowfreq_spatial_std(imgs),
             "center_corner": center_corner_contrast(imgs)}
        out["ckpts"].append(r)
        pct = (f" ({100 * r['lowfreq'] / lf_real:.0f}%/"
               f"{100 * r['center_corner'] / cc_real:.0f}% of real)"
               if lf_real else "")
        print(f"ckpt {s}: min {r['min']:.3f} max {r['max']:.3f} "
              f"div {r['div']:.3f} lowfreq {r['lowfreq']:.4f} "
              f"center-corner {r['center_corner']:.4f}{pct}")

    out["out"] = os.path.join(exp, "ckpt_evolution.png")
    image_io.imwrite(out["out"], _grid(np.stack(rows)))
    print("rows (top->bottom):", steps, "->", out["out"])
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("exp")
    p.add_argument("resolution", nargs="?", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: CUDA)")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args(sys.argv[1:])
    print(json.dumps(main(a.exp, a.resolution, a.device)))

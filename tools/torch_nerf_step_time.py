#!/usr/bin/env python3
"""Paired single-process NeRF step time of two checkouts of the PyTorch/CUDA
port, on one NVIDIA card.

Each run is a fresh process that imports ``msra_practice_project_tpu_torch``
from the checkout it is given and trains the lego recipe
(``configs/nerf/lego.json``: 1024 rays, 64 + 128 samples, K1/K2; the
synthetic scene at 400x400, 5 start-up steps) for ``--warm`` steps, then
``--steps`` more in one window timed with CUDA events (``train(...,
timed_steps=...)``: the host's per-step work counts).  The checkouts take
turns, A B, B A, A B, ..., for ``--rounds`` rounds, so a drift of the card
or the host weighs on both alike.

Prints one line per run, the card's name and power limit, and as its last
line a JSON summary: ms/step per run and per checkout (mean, min, max) and
B's mean minus A's.

Run from the repository root:
    python3 tools/torch_nerf_step_time.py A_DIR B_DIR [--steps 500]
        [--rounds 3] [--warm 50]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile


def one_run(root: str, steps: int, warm: int) -> dict:
    """Runs in the child: ms/step of ``root``'s trainer."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import msra_practice_project_tpu_torch as pkg
    from msra_practice_project_tpu_torch.core.config import (
        CONFIG_ROOT, NERF_TRAIN_DEFAULTS, load_config, resolve)
    from msra_practice_project_tpu_torch.train import train_nerf

    where = os.path.dirname(os.path.abspath(pkg.__file__))
    if not where.startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"imported the package from {where}, not {root}")
    cfg = resolve(load_config(os.path.join(CONFIG_ROOT, "nerf", "lego.json")),
                  NERF_TRAIN_DEFAULTS)
    startup = 5
    iterations = startup + warm + steps
    with tempfile.TemporaryDirectory(prefix="nerf_step_time_") as out_dir:
        cfg.update(output_path=out_dir, experiment_name="t",
                   iterations=iterations, start_up_itrs=startup,
                   i_print=iterations, i_save=iterations + 1,
                   i_image=iterations + 1, data_size=400)
        res = train_nerf.train(cfg, "cuda", timed_steps=steps)
        torch.cuda.synchronize()
    loss = res["log"]["loss"]
    if not all(v == v for v in loss):
        raise SystemExit("non-finite loss")
    return {"root": root, "ms_per_step": res["window_ms"] / steps,
            "steps": steps}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b", nargs="?")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--warm", type=int, default=50)
    ap.add_argument("--one", action="store_true",
                    help="time checkout A once in this process")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_run(args.a, args.steps, args.warm)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_nerf_step_time: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    roots = {"A": args.a, "B": args.b}
    runs = {"A": [], "B": []}
    for r in range(args.rounds):
        for side in ("AB" if r % 2 == 0 else "BA"):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), roots[side],
                 "--one", "--steps", str(args.steps), "--warm",
                 str(args.warm)], capture_output=True, text=True,
                timeout=900)
            if res.returncode != 0:
                print(res.stdout[-3000:], res.stderr[-6000:],
                      file=sys.stderr)
                return 1
            ms = json.loads(res.stdout.strip().splitlines()[-1])[
                "ms_per_step"]
            runs[side].append(ms)
            print(f"  round {r + 1} {side} ({roots[side]}): {ms:.4f} ms/step "
                  f"over {args.steps} steps", flush=True)
    print(smi)
    summary = {"card": smi, "steps": args.steps, "rounds": args.rounds}
    for side in "AB":
        v = runs[side]
        summary[side] = {"root": roots[side], "ms_per_step": v,
                         "mean": statistics.mean(v), "min": min(v),
                         "max": max(v)}
    summary["b_minus_a_ms"] = summary["B"]["mean"] - summary["A"]["mean"]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

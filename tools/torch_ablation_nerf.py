#!/usr/bin/env python3
"""Drive the NeRF ablation-analysis pipeline end to end on trained runs, for
the PyTorch/CUDA port (the counterpart of tools/ablation_nerf.py).

The reference's ablation deliverable (nerf/analysis_view.py,
nerf/analysis_param.py, 33 ablation configs) is the metric-vs-angle /
metric-vs-parameter plot suite over a sweep of trained experiments.  This
tool produces the whole chain on the analytic scene:

  1. render one shared analytic multi-view dataset (40 train views) with
     tools/torch_validate_nerf.make_dataset;
  2. train a view-count sweep (data_train_idx subsets of 5, 10 and 25, the
     lego_num_* ablation family) and one alpha-supervision variant
     (num_25_alpha, the lego_*_alpha pairing of analysis_view) through
     train_nerf.train (on CUDA: K1 and K2, the fused bf16 kernels);
  3. eval.test_nerf on every run -> test.json (angular distance, PSNR,
     SSIM, perceptual distance per view);
  4. eval.analysis_param (metric vs view count), eval.analysis_view
     (metric vs angular distance, num_25 vs num_25_alpha), both skipped
     with a note where matplotlib is not installed, and eval.demo_param
     (side-by-side grid, shared cameras).

It prints the novel-view PSNR against the view count and whether it is
monotone, for the ``ex`` split (the JAX tool's headline) and for ``in``:
the analytic dataset sets no view range, so every val view is ``in`` and
``ex`` is empty in both packages.  Beside them it prints each run's mean
PSNR over the views it trained on.  The last line is a JSON object of the
readings.

Run: python3 tools/torch_ablation_nerf.py [iterations] [size] [--device cpu]
Artifacts: <run root>/nerf_ablation/ (runs/ by default, MSRA_TPU_RUN_ROOT
overrides): the dataset, 4 experiment dirs, the plots and demo_param.jpg.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from msra_practice_project_tpu_torch import resolve_device  # noqa: E402
from msra_practice_project_tpu_torch.core.artifacts import (  # noqa: E402
    run_dir)
from msra_practice_project_tpu_torch.core.config import (  # noqa: E402
    NERF_TRAIN_DEFAULTS, resolve)

SWEEP = (5, 10, 25)
N_TRAIN = 40


def view_subsets() -> dict:
    """{"num_<n>": sorted train-view indices}: the first n of one
    ``default_rng(0)`` permutation of the 40 train views, as the JAX tool
    draws them; num_25_alpha takes num_25's views."""
    idx_full = np.random.default_rng(0).permutation(N_TRAIN)
    subsets = {f"num_{n}": sorted(int(i) for i in idx_full[:n])
               for n in SWEEP}
    subsets["num_25_alpha"] = subsets["num_25"]
    return subsets


def headline_means(runs: dict, split: str) -> dict:
    """{n: mean PSNR of ``split`` in num_<n>'s test.json} (NaN where the
    split holds no view)."""
    means = {}
    for n in SWEEP:
        with open(os.path.join(runs[f"num_{n}"], "test.json")) as f:
            data = json.load(f)
        vals = [v for v in data["psnr"][split] if v is not None]
        means[n] = float(np.mean(vals)) if vals else float("nan")
    return means


def main(iterations=2000, size=64, device=None, overrides=None) -> dict:
    """The whole pipeline; ``overrides`` replaces keys of every run's
    training config (smaller runs).  Returns the readings: the headline
    means by split, their monotonicity, the run directories and seconds."""
    from msra_practice_project_tpu_torch.eval import (analysis_param,
                                                      analysis_view,
                                                      demo_param, test_nerf)
    from msra_practice_project_tpu_torch.train import train_nerf
    from tools.torch_validate_nerf import make_dataset

    device = resolve_device(device)
    base = run_dir("nerf_ablation")
    data_dir = os.path.join(base, f"data_{size}")
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(data_dir, "transforms_train.json")):
        print(f"[ablation] rendering analytic dataset ({size}^2, {N_TRAIN} "
              "train views)...", flush=True)
        make_dataset(data_dir, size, n_train=N_TRAIN, n_val=8, n_test=8,
                     device=device)
    seconds = {"dataset": time.perf_counter() - t0}

    def train_one(exp, extra):
        log_path = os.path.join(base, exp)
        if os.path.exists(os.path.join(log_path, f"{iterations:06d}.ckpt")):
            print(f"[ablation] {exp}: trained ckpt exists — skipping train")
            return log_path
        cfg = resolve({
            "output_path": base, "experiment_name": exp,
            "data_path": data_dir, "data_resize": 1.0, "data_skip": 1,
            "iterations": iterations, "batch_size": 1024,
            "start_up_itrs": 200, "steps_per_call": 10,
            "i_print": max(iterations // 4, 1), "i_save": iterations,
            "i_image": iterations, "watchdog_timeout": 900,
            **extra, **(overrides or {}),
        }, NERF_TRAIN_DEFAULTS)
        t = time.perf_counter()
        train_nerf.train(cfg, device=device)
        seconds[f"train_{exp}"] = time.perf_counter() - t
        print(f"[ablation] {exp}: trained {iterations} iters in "
              f"{seconds[f'train_{exp}']:.0f}s", flush=True)
        return log_path

    subsets = view_subsets()
    runs = {exp: train_one(exp, {"data_train_idx": idx,
                                 **({"use_alpha": True}
                                    if exp.endswith("_alpha") else {})})
            for exp, idx in subsets.items()}

    for exp, log_path in runs.items():
        if os.path.exists(os.path.join(log_path, "test.json")):
            print(f"[ablation] {exp}: test.json exists — skipping sweep")
            continue
        t = time.perf_counter()
        test_nerf.run(log_path, None, device=device)
        seconds[f"sweep_{exp}"] = time.perf_counter() - t
        print(f"[ablation] {exp}: eval sweep in "
              f"{seconds[f'sweep_{exp}']:.0f}s", flush=True)

    # the analysis plots (the reference's signature artifacts)
    analysis_param.run(os.path.join(base, "param_num"),
                       [(float(n), runs[f"num_{n}"]) for n in SWEEP])
    analysis_view.run(os.path.join(base, "view_alpha"),
                      [runs["num_25"], runs["num_25_alpha"]])
    # ckpt_idx=None: every run has exactly one ckpt (at `iterations`), so
    # latest-per-row compares equal training amounts by construction
    demo_param.run(os.path.join(base, "demo_param.jpg"),
                   [runs[f"num_{n}"] for n in SWEEP] + [runs["num_25_alpha"]],
                   device=device)

    out = {"iterations": iterations, "size": size, "base": base,
           "runs": runs, "seconds": seconds}
    for split, what in (("ex", "novel-view (ex)"),
                        ("in", "held-out val (in)")):
        means = headline_means(runs, split)
        mono = means[5] <= means[10] <= means[25]
        print(f"[ablation] {what} PSNR vs train-view count: "
              + "  ".join(f"{n}: {means[n]:.2f} dB" for n in SWEEP))
        print(f"[ablation] monotone in view count ({split}): {mono}")
        # NaN (an empty split) as null, so the JSON line stays standard
        out[f"{split}_psnr"] = {str(n): (None if v != v else v)
                                for n, v in means.items()}
        out[f"{split}_monotone"] = mono
    # the fit of the views each run trained on, beside the held-out split:
    # a run that fits its views and misses the held-out ones overfits
    train = headline_means(runs, "train")
    print("[ablation] train-view PSNR vs train-view count: "
          + "  ".join(f"{n}: {train[n]:.2f} dB" for n in SWEEP))
    out["train_psnr"] = {str(n): v for n, v in train.items()}
    print(f"[ablation] artifacts -> {base}")
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("iterations", nargs="?", type=int, default=2000)
    p.add_argument("size", nargs="?", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: CUDA)")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args(sys.argv[1:])
    print(json.dumps(main(a.iterations, a.size, a.device)))

"""Metric-vs-viewing-angle plots from test.json sweeps (port of
``msra_practice_project_tpu/eval/analysis_view.py``): scatter and
B-spline-smoothed curves of PSNR/SSIM/LPIPS/perceptual distance against the
angular distance, for one or more experiments (typically with and without
alpha supervision).  matplotlib is imported inside ``run``; where it is
not installed, ``run`` draws nothing and says so.

Run: python -m msra_practice_project_tpu_torch.eval.analysis_view
     <out_prefix> <log_dir1> [log_dir2 ...]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def smooth_curve(x, y, n=100, s=None):
    """Sorted B-spline smoothing (ref: nerf/analysis_view.py:8-15)."""
    from scipy.interpolate import splev, splrep

    order = np.argsort(x)
    x, y = np.asarray(x)[order], np.asarray(y)[order]
    # collapse duplicate x for splrep
    ux, inv = np.unique(x, return_inverse=True)
    uy = np.zeros_like(ux)
    for i in range(len(ux)):
        uy[i] = y[inv == i].mean()
    if len(ux) < 4:
        return ux, uy
    tck = splrep(ux, uy, s=s if s is not None else len(ux))
    xs = np.linspace(ux[0], ux[-1], n)
    return xs, splev(xs, tck)


def load_test_json(log_path: str) -> dict:
    with open(os.path.join(log_path, "test.json")) as f:
        return json.load(f)


def pyplot(who: str):
    """matplotlib's pyplot on the headless Agg backend, or None (with a
    note from ``who``) where matplotlib is not installed: the plots are the
    one output that needs it."""
    try:
        import matplotlib
    except ImportError:
        print(f"[{who}] matplotlib is not installed: no plots drawn")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def run(out_prefix: str, log_paths: list[str]):
    plt = pyplot("analysis_view")
    if plt is None:
        return
    # "perceptual" is LPIPS when weights exist, else 1-MS-SSIM (test_nerf
    # writes which into test.json["perceptual_metric"])
    metric_names = ["psnr", "ssim", "lpips", "perceptual"]
    colors = ["m", "g", "b"]
    for metric in metric_names:
        plt.figure(figsize=(6, 4))
        any_data = False
        for e, log_path in enumerate(log_paths):
            data = load_test_json(log_path)
            xs, ys = [], []
            for split, marker in [("train", "o"), ("in", "s"), ("ex", "^")]:
                x = data["dist"][split]
                y = data.get(metric, {}).get(split, [])
                pairs = [(a, b) for a, b in zip(x, y) if b is not None]
                if not pairs:
                    continue
                x, y = zip(*pairs)
                xs += list(x)
                ys += list(y)
                plt.scatter(x, y, s=8, marker=marker,
                            c=colors[e % len(colors)],
                            label=f"{os.path.basename(log_path)}/{split}")
            if ys:
                any_data = True
                cx, cy = smooth_curve(xs, ys)
                plt.plot(cx, cy, c=colors[e % len(colors)])
        if not any_data:
            plt.close()
            continue
        plt.xlabel("angular distance (deg)")
        plt.ylabel(metric)
        plt.legend(fontsize=6)
        plt.tight_layout()
        out = f"{out_prefix}_{metric}.png"
        plt.savefig(out, dpi=150)
        plt.close()
        print("plot ->", out)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        raise SystemExit("usage: analysis_view <out_prefix> <log_dir> "
                         "[log_dir...]")
    run(argv[0], argv[1:])


if __name__ == "__main__":
    main()

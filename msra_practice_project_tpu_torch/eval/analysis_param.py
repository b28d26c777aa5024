"""Metric-vs-parameter line plots over an experiment sweep (port of
``msra_practice_project_tpu/eval/analysis_param.py``): the mean
PSNR/SSIM/LPIPS/perceptual distance per split against a swept parameter
value (pose noise, view count, ...), one line per split.  matplotlib is
imported inside ``run``; where it is not installed, ``run`` draws nothing
and says so.

Run: python -m msra_practice_project_tpu_torch.eval.analysis_param
     <out_prefix> <param_value:log_dir> [param_value:log_dir ...]
"""

from __future__ import annotations

import sys

import numpy as np

from .analysis_view import load_test_json, pyplot


def run(out_prefix: str, sweep: list[tuple[float, str]]):
    plt = pyplot("analysis_param")
    if plt is None:
        return
    # one read per log dir; an entry without a test.json (trained but never
    # swept by test_nerf) is skipped with a note instead of aborting
    cache = {}
    for value, log_path in sweep:
        try:
            cache[log_path] = load_test_json(log_path)
        except FileNotFoundError:
            print(f"[analysis_param] {log_path}: no test.json "
                  "(run eval.test_nerf first); skipped")
    metric_names = ["psnr", "ssim", "lpips", "perceptual"]
    for metric in metric_names:
        plt.figure(figsize=(6, 4))
        any_data = False
        for split in ["train", "in", "ex"]:
            xs, ys = [], []
            for value, log_path in sweep:
                data = cache.get(log_path)
                if data is None:
                    continue
                vals = [v for v in data.get(metric, {}).get(split, [])
                        if v is not None]
                if not vals:
                    continue
                xs.append(value)
                ys.append(float(np.mean(vals)))
            if xs:
                any_data = True
                plt.plot(xs, ys, marker="o", label=split)
        if not any_data:
            plt.close()
            continue
        plt.xscale("symlog", linthresh=1e-9)
        plt.xlabel("parameter")
        plt.ylabel(f"mean {metric}")
        plt.legend()
        plt.tight_layout()
        out = f"{out_prefix}_{metric}.png"
        plt.savefig(out, dpi=150)
        plt.close()
        print("plot ->", out)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        raise SystemExit("usage: analysis_param <out_prefix> "
                         "<value:log_dir> [value:log_dir ...]")
    sweep = []
    for spec in argv[1:]:
        value, log_path = spec.split(":", 1)
        sweep.append((float(value), log_path))
    run(argv[0], sweep)


if __name__ == "__main__":
    main()

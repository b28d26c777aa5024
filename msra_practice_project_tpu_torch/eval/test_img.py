"""Cross-model comparison of SIREN image-fitting experiments (port of
``msra_practice_project_tpu/eval/test_img.py``, ref: siren/test_img.py):
the latest render of each experiment stitched into one strip, and the
loss/PSNR curves of each ``log.npy``.  The curves need matplotlib; where it
is not installed they are skipped and the strip is still written.

Run: python -m msra_practice_project_tpu_torch.eval.test_img <out_prefix>
     <log_dir1> <log_dir2> ...
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

from ..core import image_io
from ..core.logging import MetricLogger


def latest_render(log_path: str):
    pngs = sorted(glob.glob(os.path.join(log_path, "[0-9]*.png")))
    return image_io.imread(pngs[-1]) if pngs else None


def run(out_prefix: str, log_paths: list[str]) -> dict:
    """Writes ``<out_prefix>_renders.png`` and, with matplotlib,
    ``<out_prefix>_{loss,psnr}.png``; returns the paths written."""
    written = {}
    frames = []
    for lp in log_paths:
        img = latest_render(lp)
        if img is not None:
            if img.ndim == 2:
                img = img[..., None].repeat(3, axis=-1)
            frames.append(img[..., :3])
    if frames:
        h = min(f.shape[0] for f in frames)
        strip = np.concatenate([f[:h] for f in frames], axis=1)
        written["renders"] = out_prefix + "_renders.png"
        image_io.imwrite(written["renders"], strip)
        print("strip ->", written["renders"])

    try:
        import matplotlib
    except ImportError:
        print("[test] matplotlib is not installed: no curves plotted")
        return written
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for metric in ["loss", "psnr"]:
        plt.figure(figsize=(6, 4))
        found = False
        for lp in log_paths:
            log_file = os.path.join(lp, "log.npy")
            if not os.path.exists(log_file):
                continue
            data = MetricLogger.load(log_file)
            if metric not in data or not len(data[metric]):
                continue
            found = True
            plt.plot(data[metric], label=os.path.basename(lp), linewidth=0.8)
        if not found:
            plt.close()
            continue
        if metric == "loss":
            plt.yscale("log")
        plt.xlabel("iteration")
        plt.ylabel(metric)
        plt.legend()
        plt.tight_layout()
        written[metric] = f"{out_prefix}_{metric}.png"
        plt.savefig(written[metric], dpi=150)
        plt.close()
        print("plot ->", written[metric])
    return written


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        raise SystemExit("usage: test_img <out_prefix> <log_dir> "
                         "[log_dir...]")
    run(argv[0], argv[1:])


if __name__ == "__main__":
    main()

"""Cross-model comparison of SDF-fitting experiments (port of
``msra_practice_project_tpu/eval/test_sdf.py``, ref: siren/test_sdf.py): the
loss curves of each ``log.npy`` and a table of the final ``test.ply`` meshes'
vertex and face counts (the reference compares the meshes visually).  The
curves need matplotlib; where it is not installed they are skipped and the
table is still printed.

Run: python -m msra_practice_project_tpu_torch.eval.test_sdf <out_prefix>
     <log_dir1> <log_dir2> ...
"""

from __future__ import annotations

import os
import sys

from ..core.logging import MetricLogger
from ..core.mesh import read_ply


def plot_losses(out_prefix: str, log_paths: list[str]) -> str | None:
    """``<out_prefix>_loss.png``, or None without matplotlib or logs."""
    try:
        import matplotlib
    except ImportError:
        print("[test] matplotlib is not installed: no loss curves plotted")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(6, 4))
    found = False
    for lp in log_paths:
        log_file = os.path.join(lp, "log.npy")
        if os.path.exists(log_file):
            data = MetricLogger.load(log_file)
            if "loss" in data and len(data["loss"]):
                found = True
                plt.plot(data["loss"], label=os.path.basename(lp),
                         linewidth=0.8)
    out = None
    if found:
        plt.yscale("log")
        plt.xlabel("iteration")
        plt.ylabel("loss")
        plt.legend()
        plt.tight_layout()
        out = out_prefix + "_loss.png"
        plt.savefig(out, dpi=150)
        print("plot ->", out)
    plt.close()
    return out


def run(out_prefix: str, log_paths: list[str]) -> dict:
    """Returns {"loss_plot": path or None, "meshes": {log_dir: (verts,
    faces)}} for the experiments that have a ``test.ply``."""
    plot = plot_losses(out_prefix, log_paths)
    meshes = {}
    for lp in log_paths:
        ply = os.path.join(lp, "test.ply")
        if os.path.exists(ply):
            v, f = read_ply(ply)
            meshes[lp] = (v.shape[0], f.shape[0])
            print(f"{lp}: {v.shape[0]} verts, {f.shape[0]} faces")
    return {"loss_plot": plot, "meshes": meshes}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        raise SystemExit("usage: test_sdf <out_prefix> <log_dir> "
                         "[log_dir...]")
    run(argv[0], argv[1:])


if __name__ == "__main__":
    main()

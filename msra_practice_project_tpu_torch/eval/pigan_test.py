"""pi-GAN diagnostics: D's logits on real and generated batches, their
random-conv Frechet distance and within-image structure, and the loss
curves (port of ``msra_practice_project_tpu/eval/pigan_test.py``; ref:
pi_GAN/test.py:64-85).

Run: python -m msra_practice_project_tpu_torch.eval.pigan_test <config.json>
         [--device cpu]
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import torch

from ..core.config import PIGAN_TRAIN_DEFAULTS, log_dir
from ..core.metrics import feature_distance
from ..data.image_folder import ImageFolder
from ..train import common
from ..train.train_pigan import stage_of
from .nerf_common import split_device_flag
from .pigan_demo import load_generator, resolve_saved


@torch.no_grad()
def run(config, n: int = 8, resolution: int | None = None,
        device=None) -> dict:
    """Print D's logits and the distribution diagnostics; returns them
    (``gen_logits``, and with the dataset ``real_logits``, ``rf_frechet``,
    ``spatial_std_real``, ``spatial_std_gen``; ``loss_curves`` when the
    loss log exists)."""
    generator, discriminator, step = load_generator(config, device)
    dev = next(generator.parameters()).device
    log_path = log_dir(config)
    out = {"step": step}
    if resolution is None:
        # diagnose D at the resolution the checkpoint was trained at: a
        # stage never reached has a random-init entry adapter and block
        iterations = [0] + list(config["iterations"])
        resolutions = list(config["resolution"])
        stage = min(stage_of(step, iterations), len(resolutions) - 1)
        resolution = int(resolutions[stage])
        print(f"[test] ckpt step {step} -> stage {stage}, "
              f"resolution {resolution}")
    out["resolution"] = resolution
    gen = torch.Generator(device=dev).manual_seed(0)

    # generated
    z = torch.randn(n, config["z_dim"], generator=gen, device=dev)
    imgs = generator(z, resolution, generator=gen)
    gen_logits = discriminator(imgs, resolution, -1.0).cpu().numpy()
    print("D logits (generated):", gen_logits)
    out["gen_logits"] = gen_logits

    # real (if the dataset exists)
    data_path = config["data_path"]
    if not os.path.isdir(data_path):
        data_path = os.path.join(log_path, "_synthetic_faces")
    if os.path.isdir(data_path):
        # stream exactly one batch: preloading would decode the whole set
        ds = ImageFolder(data_path, n, resize=resolution / 64.0,
                         preload=False, prefetch=False, device=dev)
        _, _, real_hwc = ds.get()
        real = real_hwc.permute(0, 3, 1, 2).contiguous()
        real_logits = discriminator(real, resolution, -1.0).cpu().numpy()
        print("D logits (real):     ", real_logits)
        # sign convention: D is trained to push real -> -inf, fake -> +inf
        print("mean real %.3f < mean fake %.3f ?"
              % (real_logits.mean(), gen_logits.mean()),
              bool(real_logits.mean() < gen_logits.mean()))
        gen_hwc = imgs.permute(0, 2, 3, 1).cpu().numpy()
        real_hwc = real_hwc.cpu().numpy()
        rf = feature_distance(gen_hwc, real_hwc)
        sp_real = float(real_hwc.std(axis=(1, 2)).mean())
        sp_gen = float(gen_hwc.std(axis=(1, 2)).mean())
        print(f"random-conv Frechet (gen vs real): {rf:.4f}")
        print(f"within-image spatial std: real {sp_real:.4f}, gen "
              f"{sp_gen:.4f} (flat-field collapse if gen << real)")
        out.update(real_logits=real_logits, rf_frechet=rf,
                   spatial_std_real=sp_real, spatial_std_gen=sp_gen)

    # loss curves
    loss_log_path = os.path.join(log_path, "loss_log.npy")
    if os.path.exists(loss_log_path):
        loss_log = np.load(loss_log_path, allow_pickle=True).item()
        out["loss_curves"] = plot_loss_curves(
            loss_log, os.path.join(log_path, "loss_curves.png"))
        if out["loss_curves"]:
            print("loss curves ->", out["loss_curves"])
    return out


def plot_loss_curves(loss_log: dict, out: str) -> str | None:
    """g/d loss-vs-iteration plot (ref: pi_GAN/test.py:78-85); returns its
    path, or None where matplotlib is not installed (the plot is the one
    output that needs it)."""
    if importlib.util.find_spec("matplotlib") is None:
        print("[test] matplotlib is not installed: no loss curves plotted")
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(6, 4))
    plt.plot(loss_log["d_loss"], label="d_loss", linewidth=0.8)
    plt.plot(loss_log["g_loss"], label="g_loss", linewidth=0.8)
    plt.xlabel("iteration")
    plt.legend()
    plt.tight_layout()
    plt.savefig(out, dpi=150)
    plt.close()
    return out


def main(argv=None):
    argv, device = split_device_flag(argv if argv is not None
                                     else sys.argv[1:])
    config = resolve_saved(common.parse_cli(argv[:1], PIGAN_TRAIN_DEFAULTS))
    return run(config, device=device)


if __name__ == "__main__":
    main()

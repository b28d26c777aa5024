"""Image IO helpers (port of ``msra_practice_project_tpu/core/image_io.py``)."""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to8b(x) -> np.ndarray:
    """Float [0,1] -> uint8, clipping (ref: nerf/render.py:5)."""
    return (255 * np.clip(_numpy(x), 0, 1)).astype(np.uint8)


def imwrite(path: str, img) -> None:
    arr = _numpy(img)
    if arr.dtype != np.uint8:
        arr = to8b(arr)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


def imread(path: str, resize: float | tuple | None = None) -> np.ndarray:
    """Read an image as float32 in [0,1]; optional resize (ratio or (W,H))."""
    img = Image.open(path)
    if resize is not None:
        if isinstance(resize, (int, float)):
            if resize != 1:
                img = img.resize(
                    (int(resize * img.width), int(resize * img.height)),
                    Image.LANCZOS)
        else:
            img = img.resize(tuple(resize), Image.LANCZOS)
    return np.array(img, dtype=np.float32) / 255.0


def mimwrite(path: str, frames, duration: float = 0.1) -> None:
    """Write an animated GIF (the reference's demos use imageio.mimwrite)."""
    imgs = []
    for f in frames:
        f = _numpy(f)
        imgs.append(Image.fromarray(f if f.dtype == np.uint8 else to8b(f)))
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(duration * 1000), loop=0)

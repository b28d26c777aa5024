"""Single-image -> (x, y, value) pairs for SIREN image fitting (port of
``msra_practice_project_tpu/data/image.py``; numpy, so the shuffled buffer is
bitwise the JAX package's).

Mirrors the inline data prep in siren/train_img.py:32-42: grayscale image,
coords meshgrid over [-1, 1]^2, pre-shuffled once.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def load_image_grayscale(path: str) -> np.ndarray:
    """[H, W, 1] float in [0, 1]."""
    img = np.array(Image.open(path).convert("L"), dtype=np.float32) / 255.0
    return img[..., None]


def image_to_coords(image: np.ndarray, shuffle: bool = True, seed: int = 0):
    """image [H, W, C] -> pos_value [H*W, 2 + C] with xy in [-1, 1]^2.

    Coordinate convention matches the reference: x varies over width, y over
    height, meshgrid order (x, y) concatenated before the intensity.
    """
    h, w = image.shape[:2]
    c = image.shape[2] if image.ndim == 3 else 1
    xs, ys = np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h))
    pos = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=1)
    vals = image.reshape(-1, c)
    pos_val = np.concatenate([pos, vals], axis=1).astype(np.float32)
    if shuffle:
        np.random.default_rng(seed).shuffle(pos_val)
    return pos_val


def make_synthetic_image(size: int = 64, seed: int = 0) -> np.ndarray:
    """Band-limited random test image (stands in for cameraman.jpg)."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(size=(size // 8, size // 8))
    img = np.array(Image.fromarray((small * 255).astype(np.uint8)).resize(
        (size, size), Image.BICUBIC), dtype=np.float32) / 255.0
    return img[..., None]

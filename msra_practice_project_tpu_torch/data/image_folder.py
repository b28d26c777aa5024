"""Flat-directory image dataset for pi-GAN training (port of
``msra_practice_project_tpu/data/image_folder.py``).

``get()`` returns (epoch_idx, batch_idx, batch ``[B, H, W, 3]`` float in
[0, 1]) with a per-epoch shuffle; ``keep_full`` drops the ragged tail batch
(ref: pi_GAN/dataloader.py:9-73).  ``preload=True`` (the default) decodes
everything once and keeps the whole dataset as one tensor on ``device``; with
``preload=False`` batches stream from disk, and ``prefetch=True`` has a worker
thread decode batch k+1 while the caller trains on batch k.  The (epoch,
batch, contents) sequence is the same either way.

``make_synthetic_faces`` writes the CelebA stand-in the trainer falls back
to when ``data_path`` is missing.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch
from PIL import Image


class _WorkerError:
    """Sentinel carrying an exception out of the prefetch thread."""

    def __init__(self, exc):
        self.exc = exc


class ImageFolder:
    def __init__(self, data_path: str, batch_size: int, resize: float = 1.0,
                 preload: bool = True, keep_full: bool = True, seed: int = 0,
                 prefetch: bool = True, prefetch_depth: int = 2,
                 device=None):
        self.data_path = data_path
        self.batch_size = batch_size
        self.resize = resize
        self.device = device
        self.files = sorted(
            os.path.join(data_path, f) for f in os.listdir(data_path)
            if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if not self.files:
            raise ValueError(f"no images found under {data_path}")
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(len(self.files))
        self._rng.shuffle(self._order)
        self.epoch_idx = 0
        self.batch_idx = 0
        n = len(self.files)
        self.batch_num = max(n // batch_size if keep_full
                             else -(-n // batch_size), 1)
        self._cache = None
        self._queue = None
        self._worker = None
        self._stop = threading.Event()
        if preload:
            self._cache = torch.from_numpy(
                np.stack([self._read(f) for f in self.files])).to(device)
        elif prefetch:
            self._queue = queue.Queue(maxsize=max(1, prefetch_depth))
            self._worker = threading.Thread(target=self._produce, daemon=True)
            self._worker.start()

    def _read(self, path: str) -> np.ndarray:
        img = Image.open(path).convert("RGB")
        if self.resize != 1:
            img = img.resize((int(self.resize * img.width),
                              int(self.resize * img.height)), Image.LANCZOS)
        return np.array(img, dtype=np.float32) / 255.0

    def __len__(self):
        return len(self.files)

    def _next_indices(self):
        """Advance the (epoch, batch, file-index) cursor: the one source of
        batch order for the direct and the prefetch path."""
        lo = self.batch_idx * self.batch_size
        hi = min(lo + self.batch_size, len(self.files))
        out = (self.epoch_idx, self.batch_idx, self._order[lo:hi].copy())
        self.batch_idx += 1
        if self.batch_idx >= self.batch_num:
            self.batch_idx = 0
            self.epoch_idx += 1
            self._rng.shuffle(self._order)
        return out

    def _produce(self):
        try:
            while not self._stop.is_set():
                epoch, bidx, idx = self._next_indices()
                stack = np.stack([self._read(self.files[i]) for i in idx])
                self._put((epoch, bidx, stack))
        except Exception as exc:  # re-raised in get()
            # an unreadable file must surface in the consumer, not end the
            # daemon thread silently and leave get() waiting forever
            self._put(_WorkerError(exc))

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def close(self):
        """Stop the prefetch worker (no-op otherwise)."""
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
            self._worker = None

    def get(self):
        """(epoch_idx, batch_idx, images ``[B, H, W, 3]`` on ``device``)."""
        if self._queue is not None:
            item = self._queue.get()
            if isinstance(item, _WorkerError):
                self._stop.set()
                raise RuntimeError(
                    "image prefetch worker failed") from item.exc
            epoch, bidx, stack = item
            return epoch, bidx, torch.from_numpy(stack).to(self.device)
        epoch, bidx, idx = self._next_indices()
        if self._cache is not None:
            batch = self._cache[torch.from_numpy(idx).to(self._cache.device)]
        else:
            batch = torch.from_numpy(np.stack(
                [self._read(self.files[i]) for i in idx])).to(self.device)
        return epoch, bidx, batch


def make_synthetic_faces(tmp_dir: str, n: int = 32, size: int = 64, seed=0,
                         shaded: bool = True, variant: str | None = None):
    """CelebA stand-in for tests, smoke and validation runs; the same images
    as the JAX package's (same numpy draws, same PNGs).

    ``variant``: "blobs" (flat Gaussian blobs), "shaded" (a Lambertian
    sphere seen from the renderer's pose prior, lit by one fixed world-frame
    light), "face" (eye/mouth albedo features at fixed world-frame
    directions) or "bigface" (the face filling the frame like a CelebA
    crop); ``shaded`` picks between the first two when ``variant`` is None.
    """
    if variant is None:
        variant = "shaded" if shaded else "blobs"
    rng = np.random.default_rng(seed)
    os.makedirs(tmp_dir, exist_ok=True)

    def save(i, img):
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(tmp_dir, f"{i:05d}.png"))

    if variant == "blobs":
        yy, xx = np.mgrid[0:size, 0:size] / (size - 1)
        for i in range(n):
            cx, cy = rng.uniform(0.3, 0.7, 2)
            r = rng.uniform(0.15, 0.3)
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r**2)))
            col = rng.uniform(0.2, 1.0, 3)
            save(i, blob[..., None] * col + (1 - blob[..., None]) * 0.9)
        return tmp_dir

    yy, xx = np.mgrid[0:size, 0:size]
    u = (xx - (size - 1) / 2) / (size / 2)          # [-1, 1] right
    v = ((size - 1) / 2 - yy) / (size / 2)          # [-1, 1] up
    light = np.array([0.5, 0.35, 0.79])
    light /= np.linalg.norm(light)
    big = variant == "bigface"
    for i in range(n):
        theta = rng.normal(0.0, 0.45)
        phi = rng.normal(0.0, 0.15)
        radius = rng.uniform(0.7, 0.95) if big else rng.uniform(0.25, 0.4)
        col = rng.uniform(0.25, 1.0, 3)
        # a sphere at a small world-space offset: its image position moves
        # with yaw/pitch, a pose-consistent cue besides the shading
        wx, wy, wz = (rng.uniform(-0.12, 0.12, 3) if big
                      else rng.uniform(-0.3, 0.3, 3))
        ct, st = np.cos(theta), np.sin(theta)
        cp, sp = np.cos(phi), np.sin(phi)
        cx = wx * ct - wz * st
        cy = wy * cp - (wx * st + wz * ct) * sp
        x, y = (u - cx) / radius, (v - cy) / radius
        rho2 = x**2 + y**2
        alpha = np.exp(-rho2 / 2.0)      # soft density
        nz = np.sqrt(np.clip(1.0 - rho2, 0.0, 1.0))
        normals = np.stack([x, y, nz], axis=-1)
        normals = normals / np.maximum(
            np.linalg.norm(normals, axis=-1, keepdims=True), 1.0)
        # the world light in the camera frame (yaw about +y, pitch about +x)
        rot_y = np.array([[ct, 0, -st], [0, 1, 0], [st, 0, ct]])
        rot_x = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        shade = np.clip(normals @ (rot_x @ (rot_y @ light)), 0.0, 1.0)
        albedo = np.broadcast_to(col, (*shade.shape, 3)).copy()
        if variant in ("face", "bigface"):
            # eyes and mouth at fixed world-frame directions on the head
            n_world = normals @ (rot_x @ rot_y)
            ex = rng.uniform(0.28, 0.42)
            ey = rng.uniform(0.08, 0.22)
            feats = [np.array([s * ex, ey, np.sqrt(max(
                1 - (s * ex) ** 2 - ey ** 2, 0.0))]) for s in (-1, 1)]
            mouth_y = rng.uniform(-0.45, -0.3)
            feats.append(np.array([0.0, mouth_y,
                                   np.sqrt(max(1 - mouth_y ** 2, 0.0))]))
            dark = rng.uniform(0.55, 0.8)
            for fdir, s_ in zip(feats, (0.12, 0.12, 0.16)):
                d2 = np.clip(1.0 - n_world @ fdir, 0.0, None)
                mask = np.exp(-d2 / (2 * s_ ** 2))
                albedo = albedo * (1.0 - dark * mask[..., None])
        fg = albedo * (0.35 + 0.65 * shade[..., None])
        save(i, alpha[..., None] * fg + (1 - alpha[..., None]) * 0.9)
    return tmp_dir

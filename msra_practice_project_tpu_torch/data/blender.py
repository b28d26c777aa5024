"""Blender-synthetic dataset loader (port of
``msra_practice_project_tpu/data/blender.py``): transforms_{train,val,test}.json
plus PNGs, with the reference's view-range filter, train-index lists,
``target_num`` subsampling and the val 'in'/'ex' split.  Host-side numpy/PIL.
``show_data_distribution`` plots the camera positions (matplotlib, imported
only there).
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from ..ops.rays import BLENDER_COORD, camera_pose_deg, pose_to_camera_pos


def _load_frame_image(file_path: str, resize: float) -> np.ndarray:
    img = Image.open(file_path)
    if resize != 1:
        img = img.resize(
            (int(resize * img.width), int(resize * img.height)),
            Image.LANCZOS)
    return np.array(img, dtype=np.float32)


def load_blender_data(file_path: str, resize: float = 1,
                      test_skip: int = 1, view_dir_range=None,
                      target_num=None, train_idx=None, *, rng=None):
    """Returns (images, poses, width, height, focal, train_idx_res).

    images/poses are dicts over {train, val, test}; the val entry is a dict
    {'in': ..., 'ex': ...}.  Images keep all 4 RGBA channels in [0, 1].
    """
    rng = rng or np.random.default_rng(0)
    file_type = ["train", "val", "test"]
    metas = {}
    for t in file_type:
        with open(os.path.join(file_path, f"transforms_{t}.json")) as fp:
            metas[t] = json.load(fp)

    images, poses = {}, {}
    train_idx_res: list[int] = []
    meta = None
    for t in file_type:
        meta = metas[t]
        ims, ps, ims_ex, ps_ex = [], [], [], []
        skip = 1 if t != "test" or test_skip == 0 else test_skip

        for frame in meta["frames"][::skip]:
            pose = BLENDER_COORD @ np.array(frame["transform_matrix"],
                                            dtype=np.float32)
            _, theta, phi = pose_to_camera_pos(pose)
            flag = False
            if t == "test":
                flag = True
            elif t == "val" or train_idx is None:
                if view_dir_range is None:
                    flag = True
                else:
                    for r in view_dir_range:
                        if r[0] < theta < r[1] and r[2] < phi < r[3]:
                            flag = True
                            break
            else:
                file_idx = int(frame["file_path"].split("_")[1])
                if file_idx in train_idx:
                    flag = True

            file_name = os.path.join(file_path, frame["file_path"] + ".png")
            if flag:
                if t == "train":
                    train_idx_res.append(
                        int(frame["file_path"].split("_")[1]))
                ims.append(_load_frame_image(file_name, resize))
                ps.append(pose)
            elif t == "val":
                ims_ex.append(_load_frame_image(file_name, resize))
                ps_ex.append(pose)

        ims = (np.array(ims) / 255.0).astype(np.float32)
        ps = np.array(ps).astype(np.float32)
        if t == "train" and target_num is not None:
            choice = rng.choice(ims.shape[0], size=target_num, replace=False)
            ims, ps = ims[choice], ps[choice]
            train_idx_res = [train_idx_res[i] for i in sorted(choice)]
        if t == "val":
            ims_ex = (np.array(ims_ex) / 255.0).astype(np.float32)
            ps_ex = np.array(ps_ex).astype(np.float32)
            images["val"] = {"in": ims, "ex": ims_ex}
            poses["val"] = {"in": ps, "ex": ps_ex}
        else:
            images[t] = ims
            poses[t] = ps

    height, width = images["train"][0].shape[:2]
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * width / np.tan(0.5 * camera_angle_x)
    return images, poses, width, height, focal, train_idx_res


def premultiply_white(images: dict) -> dict:
    """Alpha-composite every split onto a white background in place
    (ref: nerf/train_nerf.py:62-67)."""
    for v in images.values():
        splits = v.values() if isinstance(v, dict) else [v]
        for arr in splits:
            if arr.size:
                arr[..., :3] = (arr[..., :3] * arr[..., -1:]
                                + (1.0 - arr[..., -1:]))
    return images


def make_synthetic_blender(tmp_dir: str, n_train=3, n_val=2, n_test=2,
                           size=16, seed=0):
    """Write a small Blender-format dataset of random images on an orbit of
    radius 4 (for tests and smoke runs: the lego scene is not shipped)."""
    rng = np.random.default_rng(seed)
    os.makedirs(tmp_dir, exist_ok=True)

    def frames(n, prefix):
        out = []
        for i in range(n):
            theta = float(rng.uniform(-180, 180))
            phi = float(rng.uniform(-40, -5))
            # a c2w in blender coords, so BLENDER_COORD @ m round-trips
            # through pose_to_camera_pos
            c2w = camera_pose_deg(4.0, theta, phi).numpy()
            m = np.linalg.inv(BLENDER_COORD) @ c2w
            img = (rng.uniform(0, 255, size=(size, size, 4))).astype(np.uint8)
            img[..., 3] = 255
            rel = f"./{prefix}/r_{i}"
            os.makedirs(os.path.join(tmp_dir, prefix), exist_ok=True)
            Image.fromarray(img, "RGBA").save(
                os.path.join(tmp_dir, rel + ".png"))
            out.append({"file_path": rel, "transform_matrix": m.tolist()})
        return out

    for split, n in [("train", n_train), ("val", n_val), ("test", n_test)]:
        meta = {"camera_angle_x": 0.6911, "frames": frames(n, split)}
        with open(os.path.join(tmp_dir, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    return tmp_dir


def show_data_distribution(poses: dict, show_test: bool = False,
                           save_path: str | None = None):
    """3D scatter of camera positions per split
    (ref: nerf/data_loader.py:156-197).  Saves a PNG when ``save_path`` is
    given (headless), else ``plt.show()``.  matplotlib is imported here, so
    nothing else of the package needs it."""
    import matplotlib
    if save_path is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(poses["train"][:, 0, 3], poses["train"][:, 1, 3],
               poses["train"][:, 2, 3], c="m", marker="o", s=5,
               label="train")
    for split, c in [("in", "g"), ("ex", "b")]:
        p = poses["val"][split]
        if p.shape[0] > 0:
            ax.scatter(p[:, 0, 3], p[:, 1, 3], p[:, 2, 3], c=c, marker="s",
                       s=5, label=f"val_{split}")
    if show_test:
        p = poses["test"]
        ax.scatter(p[:, 0, 3], p[:, 1, 3], p[:, 2, 3], c="y", marker="^",
                   s=5, label="test")
    ax.set_xlim([-5, 5]); ax.set_ylim([-5, 5]); ax.set_zlim([-5, 5])
    ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Z")
    ax.view_init(elev=120, azim=-90)
    plt.legend()
    if save_path is not None:
        plt.savefig(save_path, dpi=300)
        plt.close(fig)
    else:
        plt.show()

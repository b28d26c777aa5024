"""tools/torch_validate_nerf.py, the port's analytic-scene NeRF quality
gate, on the CPU: its scenes against tools/validate_nerf.py's, its Blender
dataset, and main end to end at a small size (the gate itself runs on the
card, in chip_smoke.py)."""

import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.ops import rays as jrays
from msra_practice_project_tpu_torch.data.blender import (load_blender_data,
                                                          premultiply_white)
from msra_practice_project_tpu_torch.ops.render import render_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


V = _tool("torch_validate_nerf")
JV = _tool("validate_nerf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and idle OpenMP workers
    spinning after every op would take cores from the other processes of a
    parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scene", ["easy", "hard"])
def test_analytic_fields_match_the_jax_tool(scene, rng):
    """Pointwise against the JAX tool's scene at 1e-6 (of each channel's
    max) on points around and inside the spheres / shell, with random view
    directions."""
    pos = rng.uniform(-1.3, 1.3, size=(4096, 3))
    dirs = rng.normal(size=(4096, 3))
    x = np.concatenate([pos, dirs], -1).astype(np.float32)
    got = V.SCENES[scene](torch.from_numpy(x)).numpy()
    want = np.asarray(JV.SCENES[scene](jnp.asarray(x)))
    assert got.shape == want.shape == (4096, 4)
    assert want[:, 3].max() > 50 and want[:, 3].min() < 1e-3
    for c in range(4):   # rgb in [0, 1]; sigma up to 65: 1e-6 of max
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[:, c]).max())
    assert V.SPHERES == JV.SPHERES


def test_make_dataset_round_trips_through_the_blender_loader(tmp_path):
    """At 8x8: the poses are the JAX tool's draws; the loader reads the
    straight-alpha RGBA back, and composited on white it is the white-
    background render from the same view generator, within the 8-bit
    truncation of rgb and alpha (2/255)."""
    out = str(tmp_path / "data")
    focal = V.make_dataset(out, 8, n_train=3, n_val=2, n_test=2, seed=4,
                           device="cpu")
    images, poses, w, h, f, _ = load_blender_data(out, 1.0, 1)
    assert (w, h) == (8, 8) and f == pytest.approx(focal, rel=1e-6)
    assert images["train"].shape == (3, 8, 8, 4)
    assert images["val"]["in"].shape[0] == 2 and images["test"].shape[0] == 2

    rng = np.random.default_rng(4)
    for split, n in (("train", 3), ("val", 2), ("test", 2)):
        thetas, phis = rng.uniform(-180, 180, n), rng.uniform(-60, -5, n)
        got = poses["val"]["in"] if split == "val" else poses[split]
        for i in range(n):
            want = np.asarray(jrays.camera_pose_deg(4.0, float(thetas[i]),
                                                    float(phis[i])))
            np.testing.assert_allclose(got[i], want, atol=1e-5)

    premultiply_white(images)
    for i in range(3):
        gen = torch.Generator().manual_seed(V.view_seed(4, "train", i))
        rgb, _, acc = render_image(8, 8, focal, poses["train"][i], 2.0, 6.0,
                                   V.analytic_field, V.analytic_field, 64,
                                   128, generator=gen, device="cpu")
        np.testing.assert_allclose(images["train"][i][..., :3], rgb.numpy(),
                                   atol=2 / 255 + 1e-6)
        np.testing.assert_allclose(images["train"][i][..., 3:], acc.numpy(),
                                   atol=1 / 255 + 1e-6)
        assert 0 < acc.min() < 0.9 < acc.max()   # edges are partial alpha
    with open(os.path.join(out, "transforms_test.json")) as fp:
        assert json.load(fp)["camera_angle_x"] == 0.6911112


def test_main_runs_end_to_end_on_the_cpu(tmp_path):
    """A few steps at 8x8 (a small batch and few samples through
    ``overrides``): both splits scored, the experiment written, and the
    dataset cached for a second run."""
    small = {"batch_size": 32, "render_coarse_sample_num": 4,
             "render_fine_sample_num": 4, "start_up_itrs": 2}
    res = V.main(4, 8, "easy", "cpu", str(tmp_path), overrides=small)
    for split in ("train", "test"):
        psnr, ssim = res[split]
        assert np.isfinite(psnr) and 0 < psnr < 60 and -1 <= ssim <= 1
    assert res["steps"] == 4 and len(res["psnr_curve"]) == 4
    assert res["ms_per_step"] > 0
    assert os.path.exists(os.path.join(res["log_path"], "000004.ckpt"))
    data = str(tmp_path / "data_easy_8" / "train" / "r_0.png")
    stamp = os.stat(data).st_mtime_ns
    again = V.main(2, 8, "easy", "cpu", str(tmp_path), overrides=small)
    assert os.stat(data).st_mtime_ns == stamp        # dataset reused
    assert again["steps"] == 2 and os.path.exists(
        os.path.join(again["log_path"], "000002.ckpt"))
    assert not os.path.exists(os.path.join(again["log_path"],
                                           "000004.ckpt"))  # a fresh run


def test_cli_options():
    a = V.parse_args(["500", "32", "--scene=hard", "--device", "cpu",
                      "--out", "x"])
    assert (a.iterations, a.size, a.scene, a.device, a.out, a.siren) == (
        500, 32, "hard", "cpu", "x", False)
    a = V.parse_args([])
    assert (a.iterations, a.size, a.scene, a.device) == (3000, 64, "easy",
                                                         None)
    with pytest.raises(SystemExit):
        V.parse_args(["--scene=lego"])
    assert V.parse_args(["--siren"]).siren is True
    assert V.SIREN_OVERRIDES == {"use_siren": True, "learning_rate": 1e-4,
                                 "start_up_itrs": 0, "use_alpha": True}


def test_tool_imports_neither_jax_nor_matplotlib():
    """The quality-gate tools (NeRF, pi-GAN, SIREN image and SDF), the
    SDF mesh-size tool, chip_smoke.py and every module of the port (the eval scripts included)
    load no JAX, no module of the JAX package and no matplotlib: the card's
    machine has neither."""
    code = r"""
import importlib, importlib.util, pkgutil, sys
import msra_practice_project_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke  # noqa: F401
for tool in ("torch_validate_nerf", "torch_validate_pigan",
             "torch_validate_img", "torch_validate_sdf",
             "torch_sdf_mesh_sizes"):
    spec = importlib.util.spec_from_file_location(tool, f"tools/{tool}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules
       if m in ("jax", "jaxlib", "matplotlib", "msra_practice_project_tpu")
       or m.startswith(("jax.", "jaxlib.", "matplotlib.",
                        "msra_practice_project_tpu."))]
print("BAD", bad)
sys.exit(1 if bad else 0)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr

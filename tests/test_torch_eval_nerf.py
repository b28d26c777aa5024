"""The port's NeRF eval stack (msra_practice_project_tpu_torch.eval, with
ops.render.render_video, core.image_io.mimwrite, core.diagnostics and the
trainer's data_show_distribution switch), on the CPU.

render_video and render_image's jitter pass-through are held against the
JAX package's render_image; the scripts run on a small experiment that the
port's trainer writes here, mirroring the JAX package's tests/test_eval.py.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from msra_practice_project_tpu.models.nerf import nerf_model as jnerf_model
from msra_practice_project_tpu.ops import rays as jrays
from msra_practice_project_tpu.ops import render as jrender
from msra_practice_project_tpu_torch.core import diagnostics, image_io
from msra_practice_project_tpu_torch.core.config import (
    NERF_TRAIN_DEFAULTS, resolve)
from msra_practice_project_tpu_torch.models.nerf import nerf_model
from msra_practice_project_tpu_torch.ops import rays, render
from msra_practice_project_tpu_torch.weights import state_dict_from_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and idle OpenMP workers
    spinning after every op would take cores from the other processes of a
    parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# render_video, render_image(jitter=...), mimwrite
# ---------------------------------------------------------------------------


def _field_jax(x):
    p, d = x[..., :3], x[..., 3:6]
    sigma = jax.nn.relu(1.0 - jax.numpy.linalg.norm(p, axis=-1,
                                                    keepdims=True)) * 8
    return jax.numpy.concatenate([jax.nn.sigmoid(2.0 * p + 0.5 * d), sigma],
                                 -1)


def _field_torch(x):
    p, d = x[..., :3], x[..., 3:6]
    sigma = torch.relu(1.0 - torch.linalg.norm(p, dim=-1, keepdim=True)) * 8
    return torch.cat([torch.sigmoid(2.0 * p + 0.5 * d), sigma], -1)


def _fields(kind):
    """(JAX coarse, JAX fine, port coarse, port fine): a smooth analytic
    field, or two full-width NeRFs whose weights go through weights.py."""
    if kind == "analytic":
        f = jax.tree_util.Partial(_field_jax)
        return f, f, _field_torch, _field_torch
    jm = jnerf_model(False)
    out_j, out_t = [], []
    for seed in (3, 4):
        p = jm.init(jax.random.PRNGKey(seed))
        out_j.append(jax.tree_util.Partial(jm.apply, p))
        m = nerf_model()
        m.load_state_dict(state_dict_from_params(
            jax.tree_util.tree_map(np.asarray, p)))
        out_t.append(m)
    return (*out_j, *out_t)


@pytest.mark.parametrize("kind", ["analytic", "nerf"])
def test_render_video_matches_jax_render_image_per_frame(kind):
    """Three orbit frames, 8 coarse + 8 fine samples, tiles of 16 rays (the
    last one edge-padded), perturb=False: each frame against JAX's
    render_image of the same pose.

    The smooth analytic field: every element within 1e-5 of max|ref|.  The
    NeRF: 5e-4 in relative Frobenius norm per map (up to 9e-5 seen): the
    rays differ from JAX's by an ulp, the fine samples too (sample_pdf's
    cumsum), and the PE's 2^9 frequency turns that into ~1e-5..1e-4 of
    max|ref| on a few pixels; where the last fine sample meets
    sample_pdf's denom < 1e-5 guard it moves by one bin (ROADMAP.md
    section 3)."""
    jc, jf, tc, tf = _fields(kind)
    poses = [np.asarray(jrays.camera_pose_deg(4.0, th, -30.0))
             for th in (-90, 10, 130)]
    w, h, focal = 7, 6, 8.0
    rgb, depth, acc = render.render_video(
        w, h, focal, poses, 2.0, 6.0, tc, tf, 8, 8, 16, perturb=False,
        device="cpu")
    assert rgb.shape == (3, h, w, 3) and depth.shape == acc.shape == (
        3, h, w, 1)
    for i, pose in enumerate(poses):
        ref = jrender.render_image(jax.random.PRNGKey(0), w, h, focal, pose,
                                   2.0, 6.0, jc, jf, 8, 8, chunk=16,
                                   perturb=False)
        for got, want in zip((rgb[i], depth[i], acc[i]), ref):
            want = np.asarray(want)
            assert got.shape == want.shape
            if kind == "analytic":
                np.testing.assert_allclose(got, want,
                                           atol=1e-5 * np.abs(want).max())
            else:
                assert (np.linalg.norm(got - want)
                        <= 5e-4 * np.linalg.norm(want)), i


def test_render_video_draws_the_frames_in_order():
    """With perturb=True one generator draws every frame's jitter, frame
    after frame: the video equals render_image calls in a row on the same
    stream, bitwise."""
    poses = [rays.camera_pose_deg(4.0, th, -20.0) for th in (0, 60)]
    args = (6, 5, 6.0, poses, 2.0, 6.0, _field_torch, _field_torch, 8, 8, 8)
    video = render.render_video(
        *args, generator=torch.Generator().manual_seed(5), device="cpu")
    gen = torch.Generator().manual_seed(5)
    for i, pose in enumerate(poses):
        frame = render.render_image(*args[:3], pose, *args[4:],
                                    generator=gen, device="cpu")
        for got, want in zip(video, frame):
            np.testing.assert_array_equal(got[i], want.numpy())
    again = render.render_video(
        *args, generator=torch.Generator().manual_seed(6), device="cpu")
    assert not np.array_equal(again[0], video[0])


def test_render_image_jitter_matches_jax_draws():
    """perturb=True with JAX's own draws injected: one tile of 30 rays
    takes the key jax.random.split(key, 1)[0]; the port renders in tiles of
    8 (the last one edge-padded) from the same per-pixel jitter."""
    pose = jrays.camera_pose_deg(4.0, 40.0, -25.0)
    key = jax.random.PRNGKey(11)
    field = jax.tree_util.Partial(_field_jax)
    ref = jrender.render_image(key, 6, 5, 6.0, pose, 2.0, 6.0, field, field,
                               16, 16, chunk=30)
    jitter = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.split(key, 1)[0], (30, 16))))
    out = render.render_image(6, 5, 6.0, np.asarray(pose), 2.0, 6.0,
                              _field_torch, _field_torch, 16, 16, chunk=8,
                              jitter=jitter, device="cpu")
    assert float(np.asarray(ref[2]).max()) > 0.5   # the rays hit the sphere
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_mimwrite_writes_every_frame(tmp_path):
    frames = [np.full((4, 5, 3), v, np.float32) for v in (0.0, 0.5, 1.0)]
    frames[1] = torch.from_numpy(frames[1])          # tensors too
    path = str(tmp_path / "a.gif")
    image_io.mimwrite(path, frames, duration=0.2)
    with Image.open(path) as im:
        assert im.n_frames == 3 and im.size == (5, 4)
        assert im.info["duration"] == 200


# ---------------------------------------------------------------------------
# Eval scripts on a small trained experiment
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nerf_exp(tmp_path_factory):
    """8 steps of the port's trainer on the CPU (synthetic Blender scene at
    12x12, 4 + 4 samples), with data_show_distribution on."""
    from msra_practice_project_tpu_torch.train import train_nerf

    tmp_path = tmp_path_factory.mktemp("torch_nerf_eval")
    cfg = resolve({
        "output_path": str(tmp_path), "experiment_name": "exp",
        "data_path": str(tmp_path / "nonexistent"), "iterations": 8,
        "batch_size": 32, "start_up_itrs": 0, "render_coarse_sample_num": 4,
        "render_fine_sample_num": 4, "i_print": 100, "i_save": 8,
        "i_image": 100, "data_size": 12, "data_show_distribution": True,
    }, NERF_TRAIN_DEFAULTS)
    train_nerf.train(cfg, device="cpu")
    return str(tmp_path / "exp")


def test_data_show_distribution_writes_the_plot(nerf_exp):
    with Image.open(os.path.join(nerf_exp, "distribution.png")) as im:
        assert im.size[0] > 100


def test_load_experiment_restores_the_checkpoint(nerf_exp):
    from msra_practice_project_tpu_torch.core import ckpt
    from msra_practice_project_tpu_torch.eval import nerf_common

    config, (coarse, fine), state, step = nerf_common.load_experiment(
        nerf_exp, device="cpu")
    assert step == 8 and config["iterations"] == 8
    saved = ckpt.restore(ckpt.ckpt_path(nerf_exp, 8))
    for name, m in (("coarse", coarse), ("fine", fine)):
        for k, v in m.state_dict().items():
            assert torch.equal(v, saved["models"][name][k]), (name, k)
    assert nerf_common.load_experiment(nerf_exp, 8, device="cpu")[3] == 8
    with pytest.raises(FileNotFoundError):
        nerf_common.load_experiment(nerf_exp, 9, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            nerf_common.load_experiment(nerf_exp)


def test_test_nerf_sweep(nerf_exp):
    from msra_practice_project_tpu_torch.eval import test_nerf

    data = test_nerf.run(nerf_exp, 8, max_views=2, device="cpu")
    assert os.path.exists(os.path.join(nerf_exp, "test.jpg"))
    with open(os.path.join(nerf_exp, "test.json")) as f:
        loaded = json.load(f)
    assert set(loaded) == {"dist", "psnr", "ssim", "lpips", "perceptual",
                           "perceptual_metric"}
    assert loaded == json.loads(json.dumps(data))
    assert 0 < len(loaded["psnr"]["train"]) <= 2
    assert all(np.isfinite(v) for v in loaded["psnr"]["train"])
    assert all(0 <= v <= 1 for v in loaded["ssim"]["train"])
    assert all(v is None for v in loaded["lpips"]["train"])
    assert loaded["perceptual_metric"] == "1-msssim"
    assert all(v is not None and np.isfinite(v)
               for v in loaded["perceptual"]["train"])


def test_angular_distance_folds_the_seam():
    from msra_practice_project_tpu.eval.test_nerf import (
        angular_distance as jdist)
    from msra_practice_project_tpu_torch.eval.test_nerf import (
        angular_distance)

    for theta, phi in ((30.0, -20.0), (-150.0, -40.0), (170.0, -5.0)):
        pose = rays.camera_pose_deg(4.0, theta, phi).numpy()
        assert angular_distance(pose) == pytest.approx(jdist(pose),
                                                       abs=1e-4)


def test_test_nerf_sweep_arms_the_watchdog(nerf_exp, tmp_path, monkeypatch):
    """A config with watchdog_timeout arms the sweep's per-view watchdog
    (floored at 900 s) and disarms it at the end (JAX test_eval's case)."""
    from msra_practice_project_tpu_torch.eval import test_nerf

    exp = str(tmp_path / "exp")
    shutil.copytree(nerf_exp, exp)
    with open(os.path.join(exp, "config.json")) as f:
        cfg = json.load(f)
    cfg["watchdog_timeout"] = 600
    with open(os.path.join(exp, "config.json"), "w") as f:
        json.dump(cfg, f)
    made = []

    class Recording(diagnostics.Watchdog):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(test_nerf.diagnostics, "Watchdog", Recording)
    data = test_nerf.run(exp, None, max_views=1, device="cpu")
    assert np.isfinite(data["psnr"]["train"]).all()
    assert len(made) == 1 and made[0].timeout == 900.0
    assert not made[0].enabled                      # stopped after the sweep


def test_show_nerf_orbit(nerf_exp):
    from msra_practice_project_tpu_torch.eval import show_nerf

    show_nerf.main([nerf_exp, "8", "12", "10", "--device", "cpu"])
    for kind in ("rgb", "alpha"):
        with Image.open(os.path.join(nerf_exp,
                                     f"show_000008_{kind}.gif")) as im:
            assert im.n_frames == 40 and im.size == (12, 10)


def test_demo_view(nerf_exp):
    from msra_practice_project_tpu_torch.eval import demo_view

    demo_view.run(nerf_exp, device="cpu")
    with Image.open(os.path.join(nerf_exp, "demo.jpg")) as im:
        # train 0, 2 val views (all 'in': no view range): render over truth
        assert im.size == (3 * 12, 2 * 12)


def test_demo_param_and_analysis(nerf_exp, tmp_path):
    from msra_practice_project_tpu_torch.eval import (analysis_param,
                                                      analysis_view,
                                                      demo_param, test_nerf)

    out = str(tmp_path / "grid.jpg")
    demo_param.run(out, [nerf_exp, nerf_exp], n_views=2, device="cpu")
    with Image.open(out) as im:
        assert im.size == (2 * 12, 3 * 12)     # truth row + 2 experiments

    test_nerf.run(nerf_exp, None, max_views=2, device="cpu")
    prefix = str(tmp_path / "view")
    analysis_view.run(prefix, [nerf_exp])
    prefix2 = str(tmp_path / "param")
    analysis_param.run(prefix2, [(0.1, nerf_exp), (0.2, nerf_exp),
                                 (0.3, str(tmp_path / "no_test_json"))])
    for p in (prefix, prefix2):
        for metric in ("psnr", "ssim", "perceptual"):
            assert os.path.exists(f"{p}_{metric}.png"), (p, metric)
        assert not os.path.exists(f"{p}_lpips.png")   # all null: no plot


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------


def _child(tmp_path, body):
    script = tmp_path / "child.py"
    script.write_text(textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {ROOT!r})
        from msra_practice_project_tpu_torch.core.diagnostics import Watchdog
    """) + textwrap.dedent(body))
    return subprocess.run([sys.executable, str(script)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_watchdog_fires_and_exits_17(tmp_path):
    r = _child(tmp_path, f"""
        w = Watchdog(0.3, log_path={str(tmp_path)!r})
        time.sleep(30)   # never beats: the watchdog must end the process
    """)
    assert r.returncode == diagnostics.Watchdog.EXIT_CODE == 17, r.stderr
    assert "no heartbeat" in r.stderr
    assert "no heartbeat" in (tmp_path / "watchdog.log").read_text()


def test_watchdog_beats_and_pause_keep_it_quiet(tmp_path):
    r = _child(tmp_path, """
        w = Watchdog(0.4)
        for _ in range(10):      # 1 s of beats > timeout
            w.beat("step")
            time.sleep(0.1)
        w.pause()
        time.sleep(1.0)          # > timeout while paused
        w.resume()
        time.sleep(0.1)
        w.stop()
        print("SURVIVED", w.enabled)
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SURVIVED False" in r.stdout


def test_watchdog_disabled_is_a_noop():
    w = diagnostics.watchdog_from_config({"watchdog_timeout": 0})
    assert not w.enabled
    w.beat()
    w.pause()
    w.resume()
    w.stop()
    with diagnostics.watchdog_from_config({}) as w2:
        assert not w2.enabled

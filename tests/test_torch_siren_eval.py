"""The port's SIREN eval scripts (eval.test_img, eval.test_sdf) and quality
gate tools (tools/torch_validate_img.py, tools/torch_validate_sdf.py,
tools/torch_validate_nerf.py --siren) on the CPU at tiny sizes, with and
without matplotlib (the card's machine has none).  The gates themselves run
on the card, in chip_smoke.py."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from msra_practice_project_tpu_torch.core.config import (
    SIREN_IMG_DEFAULTS, SIREN_SDF_DEFAULTS, resolve)
from msra_practice_project_tpu_torch.core.logging import MetricLogger
from msra_practice_project_tpu_torch.eval import test_img, test_sdf
from msra_practice_project_tpu_torch.train import train_img, train_sdf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VI, JVI = _tool("torch_validate_img"), _tool("validate_img")
VS, JVS = _tool("torch_validate_sdf"), _tool("validate_sdf")
VN = _tool("torch_validate_nerf")
MS = _tool("torch_sdf_mesh_sizes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and idle OpenMP workers
    spinning after every op would take cores from the other processes of a
    parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hide_matplotlib(monkeypatch):
    for name in [m for m in sys.modules
                 if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


@pytest.fixture(scope="module")
def siren_runs(tmp_path_factory):
    """Two tiny image experiments and two tiny SDF experiments."""
    base = tmp_path_factory.mktemp("siren_runs")
    img, sdf = [], []
    for kind in ("siren", "relu"):
        train_img.train(resolve(dict(
            output_path=str(base), experiment_name=f"img_{kind}",
            model_type=kind, iterations=2, batch_size=32, data_size=8,
            i_print=100, i_save=2, i_image=2), SIREN_IMG_DEFAULTS),
            device="cpu")
        img.append(str(base / f"img_{kind}"))
        train_sdf.train(resolve(dict(
            output_path=str(base), experiment_name=f"sdf_{kind}",
            model_type=kind, iterations=2, batch_size=32, data_points=200,
            data_path="", i_print=100, i_save=2, i_mesh=100,
            final_mesh_n=10), SIREN_SDF_DEFAULTS), device="cpu")
        sdf.append(str(base / f"sdf_{kind}"))
    return base, img, sdf


@pytest.mark.parametrize("matplotlib", ["installed", "hidden"])
def test_test_img_strip_and_curves(siren_runs, matplotlib, monkeypatch):
    """The strip of the latest renders, side by side; the loss and PSNR
    curves where matplotlib is installed, none where it is not."""
    base, img, _ = siren_runs
    if matplotlib == "hidden":
        _hide_matplotlib(monkeypatch)
    out = str(base / f"cmp_{matplotlib}")
    written = test_img.run(out, img)
    strip = np.asarray(Image.open(written["renders"]))
    assert strip.shape == (8, 16, 3)
    render = np.asarray(Image.open(os.path.join(img[0], "000002.png")))
    np.testing.assert_array_equal(strip[:, :8, 0], render)
    want = {"renders"} | ({"loss", "psnr"} if matplotlib == "installed"
                          else set())
    assert set(written) == want
    assert all(os.path.exists(p) for p in written.values())


@pytest.mark.parametrize("matplotlib", ["installed", "hidden"])
def test_test_sdf_table_and_curve(siren_runs, matplotlib, monkeypatch,
                                  capsys):
    """The final meshes' vertex and face counts; the loss curve where
    matplotlib is installed."""
    base, _, sdf = siren_runs
    if matplotlib == "hidden":
        _hide_matplotlib(monkeypatch)
    res = test_sdf.run(str(base / f"sdf_{matplotlib}"), sdf)
    assert (res["loss_plot"] is None) == (matplotlib == "hidden")
    assert set(res["meshes"]) == set(sdf)
    out = capsys.readouterr().out
    for lp, (v, f) in res["meshes"].items():
        assert f"{lp}: {v} verts, {f} faces" in out
    assert len(MetricLogger.load(os.path.join(sdf[0], "log.npy"))["loss"]) \
        == 2


def test_validate_img_main_on_the_cpu(tmp_path):
    """The JAX tool's bars and recipe; main trains both backbones afresh
    and returns every reading (a tiny run fails the bars: exit code 1)."""
    assert VI.BARS_DB == JVI.BARS_DB and VI.BARS_REAL_DB == JVI.BARS_REAL_DB
    res = VI.main(3, 8, device="cpu", out_dir=str(tmp_path),
                  overrides={"batch_size": 16})
    assert set(res["psnr"]) == {"siren", "relu_pe"}
    assert all(np.isfinite(v) and 0 < v < 40 for v in res["psnr"].values())
    assert res["ok"] is False and res["bars"] == VI.BARS_DB
    assert all(v > 0 for v in res["ms_per_step"].values())
    for kind, lp in res["log_paths"].items():
        assert os.path.exists(os.path.join(lp, "000003.png"))
    a = VI.parse_args(["200", "32", "--real", "--device", "cpu", "--out",
                       "x"])
    assert (a.iterations, a.size, a.real, a.device, a.out) == (
        200, 32, True, "cpu", "x")
    a = VI.parse_args([])
    assert (a.iterations, a.size, a.real, a.device) == (1500, 64, False,
                                                        None)


def test_validate_img_real_photo_on_the_cpu(tmp_path, monkeypatch):
    """``--real``: the JAX tool's photo (matplotlib's grace_hopper.jpg), from
    the port's copy (byte for byte matplotlib's), read through data_path at
    its own size; here a 12 x 10 crop of it keeps the run small."""
    path = VI.real_photo_path()
    with open(path, "rb") as a, open(JVI.real_photo_path(), "rb") as b:
        assert a.read() == b.read()
    assert "matplotlib" not in path
    crop = str(tmp_path / "crop.png")
    Image.open(path).crop((200, 200, 212, 210)).save(crop)
    monkeypatch.setattr(VI, "real_photo_path", lambda: crop)
    res = VI.main(2, 8, real=True, device="cpu", out_dir=str(tmp_path),
                  overrides={"batch_size": 32})
    assert res["bars"] == VI.BARS_REAL_DB and res["ok"] is False
    with open(os.path.join(res["log_paths"]["siren"], "config.json")) as f:
        assert json.load(f)["data_path"] == crop
    render = Image.open(os.path.join(res["log_paths"]["siren"],
                                     "000002.png"))
    assert render.size == (12, 10)


@pytest.mark.parametrize("real", [False, True])
def test_validate_sdf_main_on_the_cpu(real, tmp_path):
    """The sphere gate (radius 0.6, mesh n 128 voxels) and the DEM block
    gate end to end at a tiny size, every reading returned; an untrained
    field fails the gates."""
    assert VS.RADIUS == JVS.RADIUS and VS.VOXEL == 2.0 / 127
    small = {"batch_size": 32, "mesh_n": 12, "final_mesh_n": 12}
    if real:
        res = VS.main_real(2, device="cpu", out_dir=str(tmp_path),
                           overrides=small)
        assert os.path.exists(str(tmp_path / "dem_cloud.npz"))
        assert res["in_region"] <= res["verts"]
    else:
        res = VS.main(2, device="cpu", out_dir=str(tmp_path),
                      overrides=dict(small, data_points=200))
        assert res["radius"] > 0
    assert res["ok"] is False and res["voxel"] == VS.VOXEL
    assert np.isfinite([res["loss_first"], res["loss_last50"]]).all()
    assert res["verts"] > 0 and res["faces"] > 0 and res["ms_per_step"] > 0
    assert os.path.exists(os.path.join(res["log_path"], "test.ply"))
    assert VS.error_stats(np.zeros(0)) != VS.error_stats(np.zeros(0))  # NaN
    assert VS.error_stats(np.arange(101.0)) == (50.0, 95.0)
    a = VS.parse_args(["300", "--real", "--device", "cpu"])
    assert (a.iterations, a.real, a.device, a.out) == (300, True, "cpu",
                                                      None)


def test_validate_nerf_siren_on_the_cpu(tmp_path):
    """``--siren``: the SIREN NeRF trains with the JAX tool's overrides
    (lr 1e-4, no start-up crop, alpha supervision) under its own
    experiment name, and the experiment reloads for scoring."""
    small = {"batch_size": 32, "render_coarse_sample_num": 4,
             "render_fine_sample_num": 4}
    res = VN.main(3, 8, "easy", "cpu", str(tmp_path), use_siren=True,
                  overrides=small)
    assert res["log_path"].endswith("exp_easy_siren")
    with open(os.path.join(res["log_path"], "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["use_siren"], cfg["learning_rate"], cfg["start_up_itrs"],
            cfg["use_alpha"]) == (True, 1e-4, 0, True)
    assert np.isfinite(res["test"][0]) and res["steps"] == 3
    assert VN.parse_args(["--siren"]).siren is True


def test_sdf_mesh_sizes_on_the_cpu(capsys):
    """The mesh-size tool trains once, meshes at each n in turn (one JSON
    line each) and stops once a mesh passes max_verts."""
    small = {"batch_size": 32, "data_points": 200}
    rows = MS.mesh_sizes("siren", (8, 12, 16), steps=2, max_verts=10 ** 9,
                         device="cpu", overrides=small)
    assert [r["n"] for r in rows] == [8, 12, 16]
    assert all(r["verts"] > 0 and r["faces"] > 0 and r["marching_seconds"]
               >= 0 and r["host_maxrss_gib"] > 0 for r in rows)
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [r["n"] for r in printed] == [8, 12, 16]
    rows = MS.mesh_sizes("relu_pe", (8, 12), steps=2, max_verts=0,
                         device="cpu", overrides=small)
    assert [r["n"] for r in rows] == [8]

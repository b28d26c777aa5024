"""The port's repo-level tools (tools/torch_ablation_nerf.py,
torch_soak_nerf.py, torch_profile_pigan.py, torch_film_modes.py,
torch_soak_siren.py, torch_pigan_ckpt_grids.py) end to end on the CPU at
tiny sizes, against the JAX tools where a JAX tool's logic can run here.

The soaks send a real SIGKILL to a ``--device cpu`` trainer CLI and resume
it under tools/supervise.py.  On the card the tools run through
chip_smoke.py (phases 32-37)."""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from msra_practice_project_tpu.core import ckpt as jckpt
from msra_practice_project_tpu.core.config import (
    PIGAN_TRAIN_DEFAULTS as J_PIGAN, resolve as jresolve,
    save_config as jsave_config)
from msra_practice_project_tpu.train import common as jcommon
from msra_practice_project_tpu_torch import weights
from msra_practice_project_tpu_torch.core import ckpt
from msra_practice_project_tpu_torch.core.config import (
    PIGAN_TRAIN_DEFAULTS, resolve, save_config)
from msra_practice_project_tpu_torch.models import pigan
from msra_practice_project_tpu_torch.ops.kernels import film_mlp as FK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_JSON_KEYS = {"dist", "psnr", "ssim", "lpips", "perceptual",
                  "perceptual_metric"}
# tiny NeRF runs: full-width MLPs, few rays and samples
NERF_TINY = dict(batch_size=32, start_up_itrs=2, render_coarse_sample_num=4,
                 render_fine_sample_num=4)
PIGAN_TINY = dict(z_dim=32, coarse_samples=2, fine_samples=2)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ABL, JABL = _tool("torch_ablation_nerf"), _tool("ablation_nerf")
SOAK_NERF = _tool("torch_soak_nerf")
PROFILE, MODES = _tool("torch_profile_pigan"), _tool("torch_film_modes")
SOAK_SIREN = _tool("torch_soak_siren")
GRIDS = _tool("torch_pigan_ckpt_grids")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and idle OpenMP workers
    spinning after every op would take cores from the other processes of a
    parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def run_root(tmp_path, monkeypatch):
    """A fresh durable run root; the tools' trainer CLIs on one thread."""
    monkeypatch.setenv("MSRA_TPU_RUN_ROOT", str(tmp_path / "runs"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return tmp_path / "runs"


def _hide_matplotlib(monkeypatch):
    for name in [m for m in sys.modules
                 if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


# ---------------------------------------------------------------------------
# tools/torch_ablation_nerf.py
# ---------------------------------------------------------------------------


def test_ablation_runs_end_to_end_without_matplotlib(run_root, monkeypatch,
                                                     capsys):
    """The four runs train, each gets the JAX test_nerf's test.json, the
    plots are skipped with a note (matplotlib hidden, as on the card) and
    demo_param's grid holds a truth row and four experiments."""
    _hide_matplotlib(monkeypatch)
    out = ABL.main(3, 8, device="cpu", overrides=NERF_TINY)
    base = str(run_root / "nerf_ablation")
    assert out["base"] == base
    assert sorted(out["runs"]) == ["num_10", "num_25", "num_25_alpha",
                                   "num_5"]
    for exp, log_path in out["runs"].items():
        assert os.path.exists(os.path.join(log_path, "000003.ckpt")), exp
        with open(os.path.join(log_path, "test.json")) as f:
            data = json.load(f)
        assert set(data) == TEST_JSON_KEYS
        with open(os.path.join(log_path, "config.json")) as f:
            cfg = json.load(f)
        assert cfg["data_train_idx"] == ABL.view_subsets()[exp]
        assert cfg["use_alpha"] == exp.endswith("_alpha")
        assert len(data["psnr"]["train"]) == len(cfg["data_train_idx"])
        assert len(data["psnr"]["in"]) == 8 and not data["psnr"]["ex"]
    printed = capsys.readouterr().out
    assert "[analysis_param] matplotlib is not installed" in printed
    assert "[analysis_view] matplotlib is not installed" in printed
    assert not [f for f in os.listdir(base) if f.endswith(".png")]
    with Image.open(os.path.join(base, "demo_param.jpg")) as im:
        assert im.size == (3 * 8, 5 * 8)
    # the analytic dataset has no view range: "ex" is empty, "in" holds
    # the held-out views
    assert out["ex_psnr"] == {"5": None, "10": None, "25": None}
    assert all(np.isfinite(v) for v in out["in_psnr"].values())
    assert all(np.isfinite(v) for v in out["train_psnr"].values())
    json.dumps(out)


def _fake_test_json(log_path):
    """A test.json whose PSNRs depend on the run's view count."""
    n = int(os.path.basename(log_path).split("_")[1])
    data = {k: {"train": [], "in": [], "ex": []}
            for k in ("dist", "psnr", "ssim", "lpips", "perceptual")}
    data["psnr"] = {"train": [30.0 + n], "in": [20.0 + n / 3, 21.0],
                    "ex": [10.0 + n, 11.5 + n, None]}
    data["perceptual_metric"] = "1-msssim"
    os.makedirs(log_path, exist_ok=True)
    with open(os.path.join(log_path, "test.json"), "w") as f:
        json.dump(data, f)


def _recorded_ablation(main, modules, make_dataset_mod, root, monkeypatch):
    """``main(7, 9)`` with training, the sweep, the plots and the dataset
    replaced by recorders: (configs by experiment, plot calls, result)."""
    monkeypatch.setenv("MSRA_TPU_RUN_ROOT", root)
    train_mod, test_mod, ap, av, dp = modules
    cfgs, plots = {}, []

    def record(name):
        return lambda *a, **k: plots.append(
            (name, json.loads(json.dumps(a).replace(root, "<root>"))))

    monkeypatch.setattr(make_dataset_mod, "make_dataset",
                        lambda d, *a, **k: os.makedirs(d, exist_ok=True))
    monkeypatch.setattr(train_mod, "train", lambda cfg, **k: cfgs.update(
        {cfg["experiment_name"]: dict(cfg)}))
    monkeypatch.setattr(test_mod, "run", lambda p, *a, **k:
                        _fake_test_json(p))
    for mod, name in ((ap, "analysis_param"), (av, "analysis_view"),
                      (dp, "demo_param")):
        monkeypatch.setattr(mod, "run", record(name))
    return cfgs, plots, main(7, 9)


def test_ablation_matches_the_jax_tool(tmp_path, monkeypatch):
    """The JAX tool's main and the port's, each with its package's training,
    sweep and plots replaced by the same recorders: the same run configs
    (the view subsets from one default_rng(0), alpha on num_25_alpha), the
    same plot calls and the same headline means from the same test.json
    files."""
    import tools.torch_validate_nerf as port_vn
    import tools.validate_nerf as jax_vn
    from msra_practice_project_tpu.eval import (
        analysis_param as jap, analysis_view as jav, demo_param as jdp,
        test_nerf as jtn)
    from msra_practice_project_tpu.train import train_nerf as jtrain
    from msra_practice_project_tpu_torch.eval import (
        analysis_param, analysis_view, demo_param, test_nerf)
    from msra_practice_project_tpu_torch.train import train_nerf

    jcfg, jplots, jmeans = _recorded_ablation(
        JABL.main, (jtrain, jtn, jap, jav, jdp), jax_vn,
        str(tmp_path / "jax"), monkeypatch)
    pcfg, pplots, out = _recorded_ablation(
        lambda i, s: ABL.main(i, s, device="cpu"),
        (train_nerf, test_nerf, analysis_param, analysis_view, demo_param),
        port_vn, str(tmp_path / "port"), monkeypatch)
    assert sorted(jcfg) == sorted(pcfg)
    for exp in jcfg:
        for c, root in ((jcfg[exp], "jax"), (pcfg[exp], "port")):
            for k in ("output_path", "data_path"):
                c[k] = c[k].replace(str(tmp_path / root), "<root>")
        assert pcfg[exp] == jcfg[exp], exp
    assert pplots == jplots
    assert out["ex_psnr"] == {str(n): v for n, v in jmeans.items()}
    assert out["ex_monotone"] is True
    assert out["in_psnr"]["5"] == np.mean([20.0 + 5 / 3, 21.0])
    assert out["train_psnr"] == {"5": 35.0, "10": 40.0, "25": 55.0}


# ---------------------------------------------------------------------------
# tools/torch_soak_nerf.py
# ---------------------------------------------------------------------------


def test_soak_nerf_kills_and_resumes_through_the_cli(run_root):
    """Phase A's trainer CLI gets SIGKILL past its first checkpoint at 25%;
    phase B resumes it (phase A's checkpoints untouched) to the end; the
    merged log spans every step; the test_nerf and analysis_view CLIs
    write their artifacts."""
    iterations = 60
    out = SOAK_NERF.main(iterations, 8, 4, i_save=15, poll=0.05, settle=0.0,
                         device="cpu",
                         overrides=dict(NERF_TINY, i_print=15, i_image=60))
    log_dir = out["log_dir"]
    assert log_dir == str(run_root / "nerf_soak" / "soak_60")
    assert out["kill_step"] == 15 and 15 <= out["resume_step"] < 60
    assert out["log_steps"] == iterations
    log = np.load(os.path.join(log_dir, "log.npy"), allow_pickle=True).item()
    assert len(log["loss"]) == len(log["psnr"]) == iterations
    assert np.isfinite(log["loss"]).all()
    assert [s for s, _ in ckpt.list_checkpoints(log_dir)] == [15, 30, 45, 60]
    with open(os.path.join(log_dir, "test.json")) as f:
        assert set(json.load(f)) == TEST_JSON_KEYS
    for f in ("test.jpg", "analysis_psnr.png", "000060.png"):
        assert os.path.exists(os.path.join(log_dir, f)), f
    assert out["sweep_views"] == 4 + 8
    assert set(out["summary"]) == {"train", "in"}
    assert out["eval_view_s"] > 0 and isinstance(out["pass"], bool)
    json.dumps(out)


# ---------------------------------------------------------------------------
# tools/torch_profile_pigan.py, tools/torch_film_modes.py
# ---------------------------------------------------------------------------


def test_profile_pigan_rows(monkeypatch):
    """Every row of the JAX tool, timed and finite; no kernel launches and
    no device kernels on the CPU."""
    monkeypatch.delenv("MSRA_TPU_FUSED_FILM", raising=False)
    out = PROFILE.main(2, 8, device="cpu", n=1, warmup=1,
                       gen_overrides=PIGAN_TINY)
    rows = ["G fwd (render)", "G fwd+bwd", "D fwd", "D fwd+bwd",
            "R1 double-grad", "D adv path (G fwd + D f/b on fake)",
            "full d_step", "full g_step"]
    assert list(out["ms"]) == rows
    assert all(np.isfinite(v) and v > 0 for v in out["ms"].values())
    assert out["total_ms"] == out["ms"]["full d_step"] + \
        out["ms"]["full g_step"]
    assert set(out["launches"]) == set(rows) - set(PROFILE.D_ROWS)
    assert all(v == {"k8": 0, "k8_f32": 0, "k7": 0}
               for v in out["launches"].values())
    assert out["d_kernels"] == {}
    json.dumps(out)


def test_film_modes_times_each_mode_and_restores_the_env(monkeypatch):
    """Modes 0-2 each timed (the plain versions on the CPU, no launch), the
    caller's MSRA_TPU_FUSED_FILM back after, and the tile geometry the
    kernels' own helpers give."""
    monkeypatch.setenv("MSRA_TPU_FUSED_FILM", "1")
    out = MODES.main(2, 8, ["0", "1", "2"], device="cpu", n=1, warmup=1,
                     gen_overrides=PIGAN_TINY)
    assert os.environ["MSRA_TPU_FUSED_FILM"] == "1"
    assert sorted(out["modes"]) == ["0", "1", "2"]
    for m in out["modes"].values():
        assert m["fwd_ms"] > 0 and m["fwdbwd_ms"] > 0
        assert m["fwd_launches"] == m["fwdbwd_launches"] == {
            "k8": 0, "k8_f32": 0, "k7": 0}
    coarse, fine = out["geometry"]["coarse"], out["geometry"]["fine"]
    assert coarse["points_per_image"] == 64 * 2
    assert fine["points_per_image"] == 64 * 4
    assert (coarse["tiles"], fine["tiles"]) == (4, 8)
    assert coarse["bf16_ctas"] == len(FK.cta_tiles(4)) == 2
    assert coarse["k8_f32_ctas"] is None
    monkeypatch.delenv("MSRA_TPU_FUSED_FILM")
    MODES.main(1, 8, ["2"], device="cpu", n=1, warmup=0,
               gen_overrides=PIGAN_TINY)
    assert "MSRA_TPU_FUSED_FILM" not in os.environ


# ---------------------------------------------------------------------------
# tools/torch_soak_siren.py
# ---------------------------------------------------------------------------


def test_soak_siren_image_and_sdf_with_a_kill(run_root, tmp_path,
                                             monkeypatch):
    """The image fit on a crop of grace_hopper.jpg (its full-grid render
    takes ~20 s on one CPU thread) through the train_img CLI, its PSNR from
    the final checkpoint, and the SDF fit on the DEM block through the
    train_sdf CLI, killed past its checkpoint at 25% and resumed; both logs
    span every step and the final mesh is gated."""
    import tools.torch_validate_img as VI

    crop = str(tmp_path / "crop.png")
    with Image.open(VI.real_photo_path()) as im:
        im.crop((200, 100, 232, 124)).save(crop)
    monkeypatch.setattr(VI, "real_photo_path", lambda: crop)
    out = SOAK_SIREN.main(
        2, 24, device="cpu", poll=0.05, settle=0.0,
        overrides=dict(batch_size=128, i_save=6, i_mesh=1000, mesh_n=16,
                       final_mesh_n=24))
    img, sdf = out["img"], out["sdf"]
    assert img["log_steps"] == 2 and np.isfinite(img["psnr"])
    assert img["log_dir"] == str(run_root / "siren_soak" / "img")
    assert [s for s, _ in ckpt.list_checkpoints(img["log_dir"])] == [2]
    assert sdf["kill_step"] == 6 and 6 <= sdf["resume_step"] < 24
    assert sdf["log_steps"] == 24 and np.isfinite(sdf["loss_last100"])
    assert [s for s, _ in ckpt.list_checkpoints(sdf["log_dir"])] == \
        [6, 12, 18, 24]
    assert os.path.exists(os.path.join(sdf["log_dir"], "test.ply"))
    assert sdf["verts"] > 0
    assert out["ok"] == (img["ok"] and sdf["ok"])
    json.dumps(out)


# ---------------------------------------------------------------------------
# tools/torch_pigan_ckpt_grids.py
# ---------------------------------------------------------------------------

GRID_GEN = dict(z_dim=32, resolution=8, coarse_samples=3, fine_samples=2)


def _pigan_runs(root):
    """The same two checkpoints (steps 1 and 2) as a JAX run (flax msgpack
    and the JAX package's config) and as a port run."""
    base = dict(data_path="/nonexistent", z_dim=32,
                render_coarse_sample_num=3, render_fine_sample_num=2,
                iterations=[2], fade_in_itrs=[0], batch_size=[2],
                resolution=[8], i_print=100, i_save=1, i_image=100)
    jlog, plog = os.path.join(root, "jax"), os.path.join(root, "port")
    jsave_config(jresolve(dict(base, output_path=root,
                               experiment_name="jax"), J_PIGAN), jlog)
    save_config(resolve(dict(base, output_path=root,
                             experiment_name="port"), PIGAN_TRAIN_DEFAULTS),
                plog)
    tx = jcommon.adam(jcommon.interp_lr(5e-5, 1e-5, 500), betas=(0.0, 0.9))
    for step in (1, 2):
        gen = torch.Generator().manual_seed(step)
        g = pigan.Generator(pigan.GeneratorConfig(**GRID_GEN), generator=gen)
        d = pigan.Discriminator(generator=gen)
        trees = {k: jax.tree_util.tree_map(
            jax.numpy.asarray, weights.params_from_state_dict(m.state_dict()))
            for k, m in (("g", g), ("d", d))}
        jckpt.save(jlog, step, {k: jcommon.init_state(t, tx)
                                for k, t in trees.items()} | {"step": step})
        ckpt.save(plog, step, {"g": g.state_dict(), "d": d.state_dict(),
                               "step": step})
    return jlog, plog


def test_ckpt_grids_of_a_jax_run_equal_the_port_run(tmp_path):
    """One row per checkpoint in time order; a JAX-written run and a port
    run of the same weights give the same readings and the same image."""
    jlog, plog = _pigan_runs(str(tmp_path))
    outs = [GRIDS.main(p, 8, device="cpu") for p in (jlog, plog)]
    for out, p in zip(outs, (jlog, plog)):
        assert out["steps"] == [1, 2]
        assert out["out"] == os.path.join(p, "ckpt_evolution.png")
        with Image.open(out["out"]) as im:
            assert im.size == (8 * 8, 2 * 8)
        json.dumps(out)
    assert outs[0]["ckpts"] == outs[1]["ckpts"]
    assert outs[0]["ckpts"][0] != outs[0]["ckpts"][1]
    a, b = (np.asarray(Image.open(o["out"])) for o in outs)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# every tool: CUDA unless --device cpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tool,call", [
    ("torch_ablation_nerf", lambda m: m.main(1, 8)),
    ("torch_soak_nerf", lambda m: m.main(4, 8, 2, i_save=1)),
    ("torch_profile_pigan", lambda m: m.main(2, 8)),
    ("torch_film_modes", lambda m: m.main(2, 8)),
    ("torch_soak_siren", lambda m: m.main(1, 4)),
    ("torch_pigan_ckpt_grids", lambda m: m.main("/nonexistent")),
])
def test_tool_defaults_to_cuda_and_raises_without_it(tool, call,
                                                     monkeypatch, run_root):
    """With no device given a tool runs on CUDA; without a card it raises
    before any work instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"torch_ablation_nerf": ABL, "torch_soak_nerf": SOAK_NERF,
           "torch_profile_pigan": PROFILE, "torch_film_modes": MODES,
           "torch_soak_siren": SOAK_SIREN,
           "torch_pigan_ckpt_grids": GRIDS}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(mod)
    assert not os.path.exists(run_root) or not os.listdir(run_root)
    args = mod.parse_args(["/x"] if tool == "torch_pigan_ckpt_grids"
                          else [])
    assert args.device is None

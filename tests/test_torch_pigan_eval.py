"""The port's pi-GAN evaluation stack (render_film's fov, core.artifacts,
core.mesh, eval.pigan_demo, eval.pigan_test, eval.extract_mesh and
tools/torch_validate_pigan.py) against the JAX package on the CPU, on a
tiny generator (8x8 pixels, 4 + 4 samples) with shared weights
(``weights.py``); poses, jitter and latents are injected."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.core import mesh as jmesh
from msra_practice_project_tpu.eval import extract_mesh as jextract
from msra_practice_project_tpu.eval import pigan_demo as jdemo
from msra_practice_project_tpu.models import pigan as jpigan
from msra_practice_project_tpu_torch.core import artifacts, mesh
from msra_practice_project_tpu_torch.core import ckpt as ckpt_lib
from msra_practice_project_tpu_torch.core.config import (
    PIGAN_TRAIN_DEFAULTS, log_dir, resolve, save_config)
from msra_practice_project_tpu_torch.data.image_folder import (
    make_synthetic_faces)
from msra_practice_project_tpu_torch.eval import extract_mesh, pigan_demo
from msra_practice_project_tpu_torch.eval import pigan_test
from msra_practice_project_tpu_torch.models import pigan
from msra_practice_project_tpu_torch.weights import params_from_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_CFG = dict(z_dim=64, resolution=8, coarse_samples=4, fine_samples=4)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and idle OpenMP workers
    spinning after every op would take cores from the other processes of a
    parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gen():
    """The port's tiny generator and the JAX generator with its weights."""
    g = pigan.Generator(pigan.GeneratorConfig(**GEN_CFG),
                        generator=torch.Generator().manual_seed(0))
    jg = jpigan.Generator(jpigan.GeneratorConfig(**GEN_CFG))
    return g, jg, params_from_state_dict(g.state_dict())


def make_experiment(root, seed=0, step=4):
    """An experiment directory as train_pigan leaves it, at the tiny size:
    config.json, a checkpoint of random G and D, the loss log and the
    synthetic dataset.  Returns the resolved config."""
    cfg = resolve({"output_path": str(root), "experiment_name": "exp",
                   "data_path": "/nonexistent", "z_dim": GEN_CFG["z_dim"],
                   "render_coarse_sample_num": 4,
                   "render_fine_sample_num": 4, "iterations": [step],
                   "batch_size": [2], "resolution": [8]},
                  PIGAN_TRAIN_DEFAULTS)
    path = log_dir(cfg)
    save_config(cfg, path)
    init = torch.Generator().manual_seed(seed)
    g = pigan.Generator(pigan.GeneratorConfig(z_dim=GEN_CFG["z_dim"]),
                        generator=init)
    d = pigan.Discriminator(generator=init)
    ckpt_lib.save(path, step, {"g": g.state_dict(), "d": d.state_dict(),
                               "step": step})
    np.save(os.path.join(path, "loss_log.npy"),
            {"g_loss": [0.5, 0.4, 0.3, 0.2], "d_loss": [1.0, 0.9, 0.8, 0.7]})
    make_synthetic_faces(os.path.join(path, "_synthetic_faces"), n=8)
    return cfg


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    return make_experiment(tmp_path_factory.mktemp("pigan_eval"))


def test_generator_config_surface():
    cfg = pigan.GeneratorConfig(resolution=64, fov=12.0)
    jcfg = jpigan.GeneratorConfig(resolution=64, fov=12.0)
    assert cfg.focal == jcfg.focal == pytest.approx(
        32.0 / np.tan(np.deg2rad(6.0)), rel=1e-12)
    assert cfg.with_resolution(128).resolution == 128
    assert cfg.with_resolution(128).focal == pytest.approx(2 * cfg.focal)
    r = cfg.with_render(coarse_samples=3, fov=20.0)
    assert (r.coarse_samples, r.fov, r.fine_samples) == (3, 20.0,
                                                         cfg.fine_samples)
    assert cfg.fov == 12.0   # frozen: with_* return new configs
    for c, jc in ((r, jcfg.with_render(coarse_samples=3, fov=20.0)),
                  (cfg.with_resolution(16), jcfg.with_resolution(16))):
        assert {k: getattr(c, k) for k in c.__dataclass_fields__} == \
            {k: getattr(jc, k) for k in jc.__dataclass_fields__}


@pytest.mark.parametrize("fov", [6.0, 30.0])
def test_render_film_fov_matches_jax(gen, fov):
    """render_film(fov=...) against JAX's traced fov at 1e-5 of max|ref|
    in fp32; a float and a 0-d tensor give the same image, and the default
    (fov None) path is bitwise what cfg.fov's float gave before."""
    g, jg, p = gen
    key = jax.random.PRNGKey(5)
    rng = np.random.default_rng(int(fov))
    z = rng.normal(size=(2, 64)).astype(np.float32)
    theta = rng.normal(size=2).astype(np.float32) * 0.3
    phi = rng.normal(size=2).astype(np.float32) * 0.1
    film_j = jg.get_mapping(p, jnp.asarray(z))
    ref = np.asarray(jg.render_film(p, key, film_j, jnp.asarray(theta),
                                    jnp.asarray(phi), fov=jnp.float32(fov)))
    jitter = torch.from_numpy(np.array(
        jax.random.uniform(key, (2, 64, 4), jnp.float32)))
    args = (torch.from_numpy(np.array(film_j)), torch.from_numpy(theta),
            torch.from_numpy(phi))
    with torch.no_grad():
        got = g.render_film(*args, fov=fov, jitter=jitter)
        got_t = g.render_film(*args, fov=torch.tensor(fov), jitter=jitter)
        default = g.render_film(*args, jitter=jitter)
    assert got.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max())
    assert torch.equal(got, got_t)
    assert not torch.equal(got, default)   # the fov reached the rays
    # the default path (fov None: cfg.fov's angle rounded once)
    ref_default = np.asarray(jg.render_film(p, key, film_j,
                                            jnp.asarray(theta),
                                            jnp.asarray(phi)))
    np.testing.assert_allclose(default.numpy(), ref_default,
                               atol=1e-5 * np.abs(ref_default).max())


def test_artifacts_run_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MSRA_TPU_RUN_ROOT", str(tmp_path / "root"))
    path = artifacts.run_dir("pigan_validate")
    assert path == str(tmp_path / "root" / "pigan_validate")
    assert os.path.isdir(path)
    monkeypatch.delenv("MSRA_TPU_RUN_ROOT")
    assert artifacts.durable_root() == os.path.join(ROOT, "runs")


@pytest.mark.parametrize("native", [True, False])
def test_mesh_sphere_matches_jax(native, tmp_path):
    """Marching tetrahedra on an analytic sphere SDF: the port's vertices
    and faces equal the JAX module's on the same backend; the native
    library builds into the port's build directory."""
    n = 24
    grid = np.linspace(-1.2, 1.2, n, dtype=np.float32)
    x, y, z = np.meshgrid(grid, grid, grid, indexing="ij")
    sdf = (np.sqrt(x**2 + y**2 + z**2) - 1.0).astype(np.float32)
    sp = 2.4 / (n - 1)
    v, f = mesh.marching_tetrahedra(sdf, 0.0, (sp,) * 3, (-1.2,) * 3,
                                    use_native=native)
    jv, jf = jmesh.marching_tetrahedra(sdf, 0.0, (sp,) * 3, (-1.2,) * 3,
                                       use_native=native)
    if native:
        assert mesh._load_native() is not None
        assert jmesh._load_native() is not None
        assert os.path.dirname(mesh._native._name) == mesh._BUILD_DIR
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert v.shape[0] > 100 and f.dtype == np.int32
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=0.02)
    ply = str(tmp_path / "s.ply")
    pv, pf = mesh.extract_mesh_from_grid(sdf, 0.0, (-1.2,) * 3, sp, ply)
    rv, rf = jmesh.read_ply(ply)
    np.testing.assert_array_equal(rf, pf)
    np.testing.assert_array_equal(rv, pv)


def _films_captured(module, monkeypatch):
    """Replace ``module.render_films`` by a recorder of its film codes."""
    seen = []

    def record(gen_model, *args, **kwargs):
        film = args[2] if module is jdemo else args[0]
        seen.append(np.asarray(film))
        b = film.shape[0]
        return np.zeros((b, 1, 2, 2, 3), np.float32)

    monkeypatch.setattr(module, "render_films", record)
    monkeypatch.setattr(module.image_io, "imwrite", lambda *a, **k: None)
    return seen


def test_interpolation_and_style_mix_films_match_jax(gen, monkeypatch):
    """demo_interpolate's z-lerp and w-lerp codes and demo_style_mix's
    crossovers (cut 9..0), from the same latents, against the codes JAX's
    functions hand to render_films."""
    g, jg, p = gen
    key = jax.random.PRNGKey(42)
    seen_j = _films_captured(jdemo, monkeypatch)
    seen_t = _films_captured(pigan_demo, monkeypatch)
    jdemo.demo_interpolate(jg, p, key, "x.png", cols=5)
    z2 = jax.random.normal(jax.random.fold_in(key, 0), (2, 64))
    with torch.no_grad():
        pigan_demo.demo_interpolate(g, "x.png", cols=5,
                                    z=torch.from_numpy(np.array(z2)))
    jdemo.demo_style_mix(jg, p, key, "x.png", rows=2)
    z4 = jax.random.normal(jax.random.fold_in(key, 0), (4, 64))
    pigan_demo.demo_style_mix(g, "x.png", rows=2,
                              z=torch.from_numpy(np.array(z4)))
    assert len(seen_j) == len(seen_t) == 4
    assert [a.shape for a in seen_t] == [(5, 9, 512)] * 2 + \
        [(10, 9, 512)] * 2
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # row k of a style mix: its first 9 - k layers from identity 2i (row
    # 0), the rest from identity 2i + 1 (row 9)
    mix = seen_t[2]
    for k in range(10):
        np.testing.assert_array_equal(mix[k][:9 - k], mix[0][:9 - k])
        np.testing.assert_array_equal(mix[k][9 - k:], mix[9][9 - k:])


@pytest.mark.parametrize("mode", range(7))
def test_every_demo_mode_writes_its_file(experiment, mode, monkeypatch):
    """pigan_demo.main on the CPU at 8x8 with 2 + 2 samples (mode 0's grid
    too): each mode writes its PNG (the orbit a 40-frame GIF) of the
    expected size, from the experiment's checkpoint."""
    monkeypatch.setattr(pigan_demo, "DEMO_RES", 8)
    monkeypatch.setattr(pigan_demo, "GRID_RES", 8)
    monkeypatch.setattr(pigan_demo, "DEMO_COARSE", 2)
    monkeypatch.setattr(pigan_demo, "DEMO_FINE", 2)
    cfg_path = os.path.join(log_dir(experiment), "config.json")
    out = pigan_demo.main([cfg_path, str(mode), "--device", "cpu"])
    from PIL import Image
    img = Image.open(out)
    rows, cols = {0: (8, 8), 1: (4, 9), 2: (4, 9), 3: (4, 9), 4: (1, 1),
                  5: (2, 8), 6: (4, 10)}[mode]
    assert img.size == (8 * cols, 8 * rows)
    if mode == 4:
        assert out.endswith(".gif") and img.n_frames == 40


def test_load_generator_and_pigan_test_run(experiment, tmp_path, capsys):
    """load_generator restores the checkpoint's G and D (frozen) and warns
    with a fresh init when there is none; pigan_test.run prints D's logits
    at the checkpoint's stage resolution, the random-conv Frechet and the
    spatial std, and plots the loss curves."""
    g, d, step = pigan_demo.load_generator(experiment, "cpu")
    saved = ckpt_lib.restore_latest(log_dir(experiment))[1]
    assert step == 4
    for k, v in saved["g"].items():
        assert torch.equal(g.state_dict()[k], v)
    assert not any(p.requires_grad for p in g.parameters())
    assert not any(p.requires_grad for p in d.parameters())
    empty = dict(experiment, output_path=str(tmp_path))
    _, _, step0 = pigan_demo.load_generator(empty, "cpu")
    assert step0 == 0 and "[warn] no checkpoint" in capsys.readouterr().out
    out = pigan_test.run(experiment, n=4, device="cpu")
    text = capsys.readouterr().out
    assert "stage 0, resolution 8" in text and "D logits (real)" in text
    assert out["resolution"] == 8 and out["gen_logits"].shape == (4,)
    assert out["real_logits"].shape == (4,)
    assert np.isfinite(out["rf_frechet"]) and out["spatial_std_real"] > 0
    assert os.path.exists(out["loss_curves"])
    # the pose prior's scatter (matplotlib)
    path = str(tmp_path / "poses.png")
    pigan_demo.show_pose_distribution(g, 50, path,
                                      generator=torch.Generator())
    assert os.path.getsize(path) > 0


def test_extract_mesh_sigma_grid_matches_jax(experiment, tmp_path, capsys):
    """The -sigma grid slice by slice against JAX's _sigma_slice on the
    same film code, at the trunk's parity tolerance (2e-5, as
    tests/test_torch_pigan.py holds the trunk; the two linspaces differ by
    an ulp, which w0 = 30 amplifies), the empty-isosurface message at
    level -20, and a mesh at a level inside the field's range."""
    g, _, _ = pigan_demo.load_generator(experiment, "cpu")
    p = params_from_state_dict(g.state_dict())
    jg = jpigan.Generator(jpigan.GeneratorConfig(z_dim=64))
    z = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 64)).astype(np.float32))
    n = 12
    out = str(tmp_path / "m")
    verts, faces, values = extract_mesh.extract_mesh(g, out, n=n, z=z)
    film = jnp.asarray(g.get_mapping(z).numpy())
    xs = np.linspace(-0.1, 0.1, n)
    ref = np.stack([np.asarray(jextract._sigma_slice(
        p["trunk"], film, jnp.float32(x), trunk_apply=jg.trunk.apply, n=n))
        for x in xs])
    assert values.shape == (n, n, n)
    np.testing.assert_allclose(values, ref,
                               atol=2e-5 * max(1.0, np.abs(ref).max()))
    if verts.shape[0] == 0:
        assert "empty isosurface" in capsys.readouterr().out
    level = float(np.median(values))
    v2, f2 = extract_mesh.march(values, out + "_mid", level)
    assert v2.shape[0] > 0 and f2.shape[0] > 0
    rv, rf = jmesh.read_ply(out + "_mid.ply")
    np.testing.assert_array_equal(rf, f2)
    # the module's CLI on the experiment
    extract_mesh.main([os.path.join(log_dir(experiment),
                                            "config.json"), "8",
                               "--device", "cpu"])
    assert os.path.exists(os.path.join(log_dir(experiment),
                                       "mesh_000004.ply"))


V = _tool("torch_validate_pigan")
JV = _tool("validate_pigan")


def test_validation_helpers_match_the_jax_tool(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(6, 16, 16, 3)).astype(np.float32)
    other = np.clip(imgs * 0.5 + 0.3, 0, 1)
    np.testing.assert_array_equal(V.color_hist(imgs), JV.color_hist(imgs))
    for fn in ("lowfreq_spatial_std", "center_corner_contrast"):
        assert getattr(V, fn)(imgs) == getattr(JV, fn)(imgs)
    np.testing.assert_array_equal(V.corner_patches(imgs),
                                  JV.corner_patches(imgs))
    bg = float(np.median(V.corner_patches(other)))
    assert V.corner_background_error(imgs, bg) == \
        JV.corner_background_error(imgs, bg)
    # the resume decision, on and off the durable directory's checkpoints
    exp = str(tmp_path / "exp")
    monkeypatch.delenv("SUPERVISE_ATTEMPT", raising=False)
    cases = [(False, False), (True, False), (False, True), (True, True)]
    for resume, fresh in cases:
        assert V.decide_resume(exp, resume, fresh) == \
            JV.decide_resume(exp, resume, fresh)
    ckpt_lib.save(exp, 3, {"step": 3})
    from msra_practice_project_tpu.core import ckpt as jckpt
    jckpt.save(exp, 3, {"step": np.int32(3)})
    for resume, fresh in cases:
        assert V.decide_resume(exp, resume, fresh) is True or fresh
        assert V.decide_resume(exp, resume, fresh) == \
            JV.decide_resume(exp, resume, fresh)
    monkeypatch.setenv("SUPERVISE_ATTEMPT", "2")
    assert V.decide_resume(exp, False, True) is True


def test_validate_main_runs_and_returns_every_reading(tmp_path,
                                                      monkeypatch):
    """torch_validate_pigan.main for 3 iterations on the CPU at 8x8 with
    2 + 2 samples: every reading comes back, finite, with the verdict."""
    monkeypatch.setenv("MSRA_TPU_RUN_ROOT", str(tmp_path))
    monkeypatch.setattr(V, "DEMO_RES", 8)
    monkeypatch.setattr(V, "DEMO_SAMPLES", (2, 2))
    out = V.main(3, batch0=2, data_n=64, zdim=16, device="cpu",
                 overrides={"resolution": [8],
                            "render_coarse_sample_num": 2,
                            "render_fine_sample_num": 2})
    keys = ("hist0", "hist1", "rf_frechet0", "rf_frechet1", "d_frechet0",
            "d_frechet1", "d_frechet_floor", "diversity", "spatial_real",
            "spatial0", "spatial1", "lowfreq_real", "lowfreq1", "g_tail",
            "yaw_delta")
    for k in keys:
        assert np.isfinite(out[k]), k
    assert isinstance(out["pass"], bool) and out["finite"]
    assert out["iterations"] == 3 and out["resolution"] == 8
    assert out["ckpt_steps"] == [1, 2, 3] and len(out["div_traj"]) == 3
    assert len(out["loss_log"]["g_loss"]) == 3
    exp = out["exp_dir"]
    assert exp == str(tmp_path / "pigan_validate" / "exp")
    for f in ("samples_final.png", "samples_real.png", "demo_8.png",
              "ckpt_evolution.png", "loss_curves.png", "config.json"):
        assert os.path.exists(os.path.join(exp, f)), f


def test_chip_smoke_accepts_k7_bs_only_when_relu_flips_explain_it():
    """chip_smoke.py lets K7's sigma-bias gradient past its gate only when
    it is the exact sum of dy over the kernel's own relu mask and the
    flipped points' sigma is near zero."""
    import chip_smoke
    g = torch.Generator().manual_seed(0)
    plain = torch.randn(1, 1000, 8, generator=g).clamp(min=0)
    dy = torch.randn(1, 1000, 8, generator=g) * 1e-3
    i, j = (plain[0, :, 3] == 0).nonzero()[:2, 0].tolist()
    for sigma, want in ((1e-3, True), (0.2, False)):
        kern = plain.clone()
        kern[0, i, 3] = sigma     # a flip: 0 in the plain version
        bs = (dy[..., 3] * (kern[..., 3] > 0)).sum().reshape(1, 1)
        assert chip_smoke.relu_flips_explain_bs(kern, plain, dy, bs) is want
    kern = plain.clone()
    kern[0, i, 3] = kern[0, j, 3] = 1e-3
    bs = (dy[..., 3] * (kern[..., 3] > 0)).sum().reshape(1, 1)
    assert chip_smoke.relu_flips_explain_bs(kern, plain, dy, bs)
    assert not chip_smoke.relu_flips_explain_bs(kern, plain, dy, bs + 1e-4)

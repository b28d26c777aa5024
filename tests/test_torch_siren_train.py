"""The port's SIREN trainers (msra_practice_project_tpu_torch.train.train_img,
train_sdf) and the SirenNeRF train step against the JAX package, on the CPU,
and the trainers end to end at tiny sizes.

The same numpy-seeded inputs and bridged weights go through both packages.
jax.random streams cannot be replayed in torch, so the off-surface points
and the stratified jitter are drawn with JAX and injected.  Adam's first
step is about lr * sign(g), so updated parameters are compared on identical
gradients."""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.core.config import (
    NERF_TRAIN_DEFAULTS as J_NERF_DEFAULTS)
from msra_practice_project_tpu.models import siren_mlp as jsiren
from msra_practice_project_tpu.models.nerf import nerf_model as jnerf_model
from msra_practice_project_tpu.train import common as jcommon
from msra_practice_project_tpu.train import train_img as jtrain_img
from msra_practice_project_tpu.train import train_sdf as jtrain_sdf
from msra_practice_project_tpu.train.train_nerf import _make_step_impl
from msra_practice_project_tpu_torch.core import ckpt
from msra_practice_project_tpu_torch.core import mesh as mesh_lib
from msra_practice_project_tpu_torch.core.config import (
    NERF_TRAIN_DEFAULTS, SIREN_IMG_DEFAULTS, SIREN_SDF_DEFAULTS, resolve)
from msra_practice_project_tpu_torch.core.logging import MetricLogger
from msra_practice_project_tpu_torch.data import image as image_data
from msra_practice_project_tpu_torch.data.pointcloud import (
    make_synthetic_sphere_cloud)
from msra_practice_project_tpu_torch.models import siren_mlp
from msra_practice_project_tpu_torch.models.nerf import nerf_model
from msra_practice_project_tpu_torch.train import (common, train_img,
                                                   train_nerf, train_sdf)
from msra_practice_project_tpu_torch.weights import (
    params_from_state_dict, state_dict_from_params)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and idle OpenMP workers
    spinning after every op would take cores from the other processes of a
    parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _pair(factory, kind, seed=1):
    jm = getattr(jsiren, factory)(kind)
    p = jm.init(jax.random.PRNGKey(seed))
    tm = getattr(siren_mlp, factory)(kind)
    tm.load_state_dict(state_dict_from_params(_np_tree(p)))
    return jm, p, tm


def _grads(model):
    return jax.tree_util.tree_leaves(params_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()}))


def _load_grads(model, grads_tree):
    """Set every parameter's .grad from a JAX-layout gradient tree."""
    sd = state_dict_from_params(_np_tree(grads_tree))
    for k, p in model.named_parameters():
        p.grad = sd[k].clone()


# -- the SDF loss ----------------------------------------------------------

@pytest.mark.parametrize("kind", siren_mlp.KINDS)
def test_sdf_loss_and_its_grad_in_grad_match_jax(kind):
    """The 4-term loss and its parameter gradients (through the input
    gradients) against JAX sdf_loss on the same 128 on-surface points of the
    synthetic sphere and 128 injected off-surface points: the loss at 1e-5
    relative, every gradient at 1e-4 relative Frobenius norm."""
    jm, p, tm = _pair("sdf_model", kind, seed=2)
    cloud = make_synthetic_sphere_cloud(128, seed=3)
    off = np.random.default_rng(4).uniform(
        -1, 1, size=(128, 3)).astype(np.float32)
    on, norm = cloud[:, :3], cloud[:, 3:]
    loss_j, g_j = jax.value_and_grad(lambda q: jtrain_sdf.sdf_loss(
        jm.apply, q, jnp.asarray(on), jnp.asarray(norm),
        jnp.asarray(off)))(p)
    loss_t = train_sdf.sdf_loss(tm, torch.from_numpy(on),
                                torch.from_numpy(norm), torch.from_numpy(off))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert train_sdf.LOSS_WEIGHTS == jtrain_sdf.LOSS_WEIGHTS
    for a, b in zip(_grads(tm), jax.tree_util.tree_leaves(_np_tree(g_j))):
        assert a.shape == b.shape
        assert _rel(a, b) < 1e-4, (kind, a.shape, _rel(a, b))


# -- the image step --------------------------------------------------------

@pytest.mark.parametrize("kind", siren_mlp.KINDS)
def test_train_img_steps_match_jax_train_step(kind):
    """Four steps of train_img's step on the shuffled buffer of a 16 x 16
    synthetic image (batch 64), against four calls of JAX _train_step
    (steps_per_call 1) from the same weights: the first step's loss at
    1e-5 relative and its gradients at 1e-5 relative Frobenius norm; the
    later losses, after Adam's ~lr * sign(g) moves, at 1e-3 relative.  Then
    Adam on the JAX step's own gradients gives its parameters at 1e-6."""
    buf = image_data.image_to_coords(image_data.make_synthetic_image(16))
    jm, p, tm = _pair("img_model", kind, seed=5)
    tx = jcommon.adam(1e-4)
    state = jcommon.init_state(p, tx)
    apply_fn = jax.tree_util.Partial(jm.apply)
    losses_j, first_state = [], None
    for i in range(4):
        state, m = jtrain_img._train_step(state, jnp.asarray(buf), i * 64,
                                          apply_fn=apply_fn, tx=tx,
                                          batch_size=64)
        losses_j.append(float(m["loss"]))
        first_state = first_state or state
    g_j = jax.tree_util.tree_map(           # Adam's mu = (1 - b1) g
        lambda mu: np.asarray(mu) / 0.1, first_state["opt_state"][0].mu)

    opt = common.adam(list(tm.parameters()), 1e-4)
    step = train_img.make_train_step(tm, opt)
    losses_t = []
    for i in range(4):
        m = step(torch.from_numpy(buf[i * 64:(i + 1) * 64]))
        losses_t.append(float(m["loss"]))
        np.testing.assert_allclose(float(m["psnr"]),
                                   -10 * np.log10(losses_t[-1]), rtol=1e-6)
        if i == 0:
            for a, b in zip(_grads(tm),
                            jax.tree_util.tree_leaves(_np_tree(g_j))):
                assert _rel(a, b) < 1e-5, (kind, a.shape, _rel(a, b))
    np.testing.assert_allclose(losses_t[0], losses_j[0], rtol=1e-5)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)

    _, _, tm = _pair("img_model", kind, seed=5)
    opt = common.adam(list(tm.parameters()), 1e-4)
    _load_grads(tm, g_j)
    opt.step()
    for a, b in zip(jax.tree_util.tree_leaves(
            params_from_state_dict(tm.state_dict())),
            jax.tree_util.tree_leaves(_np_tree(first_state["params"]))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_render_grid_matches_jax():
    """The full-grid render over [-1, 1]^2 (x over width) at 2e-5 x max(1,
    max|ref|), the sine tolerance."""
    jm, p, tm = _pair("img_model", "siren", seed=6)
    want = np.asarray(jtrain_img.render_grid(p, apply_fn=jm.apply, width=12,
                                             height=7))
    got = train_img.render_grid(tm, 12, 7).numpy()
    assert got.shape == want.shape == (7, 12)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * max(1, np.abs(want).max()))


def _img_cfg(tmp_path, **kw):
    return resolve(dict(dict(
        output_path=str(tmp_path), experiment_name="img", batch_size=64,
        data_size=16, i_print=100, i_save=3, i_image=3), **kw),
        SIREN_IMG_DEFAULTS)


def test_train_img_trainer_renders_checkpoints_and_resumes(tmp_path):
    """Renders and checkpoints on their cadence, the timed window around
    the last steps, the log written before the checkpoint, and a resume that
    truncates a log that ran ahead of the newest checkpoint and spans the
    whole run."""
    seen = []

    @contextlib.contextmanager
    def window():
        seen.append("open")
        yield
        seen.append("close")

    out = train_img.train(_img_cfg(tmp_path, iterations=6), device="cpu",
                          timed_steps=2, window=window())
    log = tmp_path / "img"
    for s in (3, 6):
        assert (log / f"{s:06d}.png").exists()
        assert (log / f"{s:06d}.ckpt").exists()
    assert seen == ["open", "close"] and out["window_ms"] > 0
    assert (out["width"], out["height"]) == (16, 16)
    first = out["log"]["loss"]
    assert len(first) == 6 and np.isfinite(first).all()
    assert ckpt.restore(str(log / "000006.ckpt"))["opt"]["count"] == 6

    os.remove(log / "000006.ckpt")      # the log ran ahead of the ckpt
    res = train_img.train(_img_cfg(tmp_path, iterations=9), device="cpu")
    assert res["window_ms"] is None
    assert res["state"]["step"] == 9 and res["state"]["opt"].count == 9
    merged = MetricLogger.load(str(log / "log.npy"))["loss"]
    assert len(merged) == 9
    np.testing.assert_array_equal(merged[:3], first[:3])


# -- the SDF trainer -------------------------------------------------------

def test_sdf_streams_are_seeded_per_step_and_epoch():
    """The off-surface points of a step and the permutation of an epoch
    depend on (seed, step) and (seed, epoch) only."""
    a = train_sdf.off_surface_points(500, 0, 7, "cpu")
    assert torch.equal(a, train_sdf.off_surface_points(500, 0, 7, "cpu"))
    assert not torch.equal(a, train_sdf.off_surface_points(500, 0, 8, "cpu"))
    assert not torch.equal(a, train_sdf.off_surface_points(500, 1, 7, "cpu"))
    assert a.shape == (500, 3) and -1 <= a.min() and a.max() < 1
    assert a.min() < -0.95 and a.max() > 0.95
    cloud = torch.arange(60.0).reshape(10, 6)
    s1 = train_sdf.shuffled(cloud, 0, 1)
    assert torch.equal(s1, train_sdf.shuffled(cloud, 0, 1))
    assert not torch.equal(s1, train_sdf.shuffled(cloud, 0, 2))
    assert torch.equal(s1[:, 0].sort().values, cloud[:, 0])
    assert torch.equal(s1[:, 1] - s1[:, 0], torch.ones(10))   # whole rows


def test_sdf_grid_matches_jax_sdf_slice(tmp_path):
    """The n^3 grid slice by slice against JAX _sdf_slice at n 10 (2e-5 x
    max(1, max|ref|): the two linspaces may differ by an ulp, which w0 = 30
    amplifies); create_mesh writes the PLY of exactly that grid's
    isosurface."""
    jm, p, tm = _pair("sdf_model", "siren", seed=7)
    n = 10
    want = np.stack([np.asarray(jtrain_sdf._sdf_slice(
        p, jnp.float32(x), apply_fn=jm.apply, n=n))
        for x in np.linspace(-1, 1, n)])
    got = train_sdf.sdf_grid(tm, n)
    assert got.shape == (n, n, n)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * max(1, np.abs(want).max()))
    level = float(np.median(got))
    values, verts, faces = train_sdf.create_mesh(
        tm, str(tmp_path / "m"), n=n, level=level)
    v2, f2 = mesh_lib.extract_mesh_from_grid(values, level, (-1.0,) * 3,
                                             2.0 / (n - 1))
    np.testing.assert_array_equal(verts, v2)
    np.testing.assert_array_equal(faces, f2)
    rv, rf = mesh_lib.read_ply(str(tmp_path / "m.ply"))
    assert len(rv) == len(verts) > 0 and len(rf) == len(faces)


def test_train_sdf_trainer_meshes_resumes_and_reshuffles(tmp_path,
                                                        monkeypatch):
    """Meshes at i_mesh and the final mesh at final_mesh_n, checkpoints,
    one reshuffle per epoch boundary, and a resume whose log spans the whole
    run with the first run's losses as its prefix."""
    cfg = dict(output_path=str(tmp_path), experiment_name="sdf",
               data_path="", data_points=300, batch_size=64, i_print=100,
               i_save=2, i_mesh=2, mesh_n=10, final_mesh_n=12)
    epochs = []
    orig = train_sdf.shuffled
    monkeypatch.setattr(train_sdf, "shuffled",
                        lambda c, s, e: (epochs.append(e), orig(c, s, e))[1])
    out = train_sdf.train(resolve(dict(cfg, iterations=4),
                                  SIREN_SDF_DEFAULTS), device="cpu",
                          timed_steps=2)
    log = tmp_path / "sdf"
    for name in ("000002.ply", "000004.ply", "test.ply", "000002.ckpt",
                 "000004.ckpt", "log.npy", "config.json"):
        assert (log / name).exists(), name
    # 300 points in batches of 64: 4 steps per epoch; the epoch-0 shuffle
    # before the first step, epoch 1's after step 4
    assert epochs == [0, 1] and out["window_ms"] > 0
    first = out["log"]["loss"]
    assert len(first) == 4 and np.isfinite(first).all()
    assert out["model"].cfg.kind == "siren"

    res = train_sdf.train(resolve(dict(cfg, iterations=6),
                                  SIREN_SDF_DEFAULTS), device="cpu")
    assert res["state"]["step"] == 6 and len(res["log"]["loss"]) == 6
    np.testing.assert_array_equal(res["log"]["loss"][:4], first)
    assert ckpt.latest(str(log))[0] == 6


# -- the SirenNeRF train step ----------------------------------------------

def test_siren_nerf_step_matches_jax_step():
    """One train_nerf step with use_siren (lego_siren's lr 1e-4 and alpha
    loss) against JAX _make_step_impl with the same weights, batch and
    coarse jitter: metrics at 1e-5 relative, gradients at 1e-4 relative
    Frobenius norm (the fine samples come from sample_pdf's cumsum, which
    rounds in another order in JAX; without the PE's 2^9 frequency the
    PE step test's 5e-3 is not needed), Adam on identical gradients at
    1e-6."""
    cfg = dict(J_NERF_DEFAULTS, use_siren=True, use_alpha=True,
               learning_rate=1e-4, render_coarse_sample_num=9,
               render_fine_sample_num=17)
    jm = jnerf_model(True)
    params = {"coarse": jm.init(jax.random.PRNGKey(0)),
              "fine": jm.init(jax.random.PRNGKey(1))}
    tx = jcommon.adam(jcommon.exponential_lr(1e-4, 500))
    rng = np.random.default_rng(0)
    ro = rng.normal(size=(32, 3)) * 0.1 + [0, 0, 4.0]
    rd = -ro / np.linalg.norm(ro, axis=-1, keepdims=True) \
        + 0.1 * rng.normal(size=(32, 3))
    batch = np.concatenate([ro, rd, rng.uniform(size=(32, 4))],
                           1).astype(np.float32)
    key = jax.random.PRNGKey(7)
    new_state, m_j = _make_step_impl(jm, jm, tx, cfg)(
        jcommon.init_state(params, tx), jnp.asarray(batch), key)
    grads_j = jax.tree_util.tree_map(
        lambda mu: np.asarray(mu) / 0.1, new_state["opt_state"][0].mu)

    def port_models():
        models = {}
        for name, p in params.items():
            models[name] = nerf_model(True)
            models[name].load_state_dict(state_dict_from_params(_np_tree(p)))
        return models

    models = port_models()
    opt = common.adam([p for m in models.values() for p in m.parameters()],
                      common.exponential_lr(1e-4, 500))
    step = train_nerf.make_train_step(models["coarse"], models["fine"], opt,
                                      cfg, device="cpu")
    jitter = torch.from_numpy(np.array(
        jax.random.uniform(key, (32, 9), jnp.float32)))
    m_t = step(torch.from_numpy(batch), jitter=jitter)
    for k in ("loss", "loss_coarse", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    for name, model in models.items():
        for a, b in zip(jax.tree_util.tree_leaves(grads_j[name]),
                        _grads(model)):
            assert _rel(b, a) < 1e-4, (name, a.shape, _rel(b, a))

    models = port_models()
    opt = common.adam([p for m in models.values() for p in m.parameters()],
                      common.exponential_lr(1e-4, 500))
    for name, model in models.items():
        _load_grads(model, grads_j[name])
    opt.step()
    for name, model in models.items():
        for a, b in zip(jax.tree_util.tree_leaves(
                _np_tree(new_state["params"][name])),
                jax.tree_util.tree_leaves(
                    params_from_state_dict(model.state_dict()))):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_siren_nerf_trains_on_the_cpu(tmp_path):
    """train_nerf.train on lego_siren's switches at a tiny size: the SIREN
    models are built, saved and reloadable."""
    cfg = resolve(dict(output_path=str(tmp_path), experiment_name="ls",
                       data_path="/nonexistent", data_size=8, batch_size=32,
                       iterations=3, start_up_itrs=0, use_siren=True,
                       use_alpha=True, learning_rate=1e-4,
                       render_coarse_sample_num=4, render_fine_sample_num=4,
                       i_print=100, i_save=3, i_image=3),
                  NERF_TRAIN_DEFAULTS)
    out = train_nerf.train(cfg, device="cpu")
    assert np.isfinite(out["log"]["loss"]).all()
    assert all(m.cfg.use_siren for m in out["models"])
    saved = ckpt.restore(str(tmp_path / "ls" / "000003.ckpt"))
    assert saved["models"]["coarse"]["layers_pos.5.weight"].shape == \
        (256, 259)
    assert (tmp_path / "ls" / "000003.png").exists()

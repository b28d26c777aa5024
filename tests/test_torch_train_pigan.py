"""The port's pi-GAN train steps, trainer and data
(msra_practice_project_tpu_torch.train.train_pigan, data.image_folder)
against the JAX package, on the CPU.

One D step and one G step at full trunk and discriminator width (a batch of
2 at 8x8) must match the JAX package's ``g.apply``, ``d.apply``,
``r1_penalty`` and ``loss_f`` with the same weights, latents and random
draws.  5 coarse samples make the linspace exact; the fine samples come out
of ``sample_pdf``'s cumsum, which the two frameworks round in another order,
so gradients are compared in relative Frobenius norm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.core.logging import (
    flush_scalar_list as jflush)
from msra_practice_project_tpu.data import image_folder as jdata
from msra_practice_project_tpu.models import pigan as jpigan
from msra_practice_project_tpu.train import common as jcommon
from msra_practice_project_tpu.train import train_pigan as jtrain
from msra_practice_project_tpu_torch.core import ckpt
from msra_practice_project_tpu_torch.core.config import (
    CONFIG_ROOT, PIGAN_TRAIN_DEFAULTS, load_config, resolve)
from msra_practice_project_tpu_torch.core.logging import flush_scalar_list
from msra_practice_project_tpu_torch.data import image_folder as data
from msra_practice_project_tpu_torch.models import pigan
from msra_practice_project_tpu_torch.ops.kernels import film_mlp as K
from msra_practice_project_tpu_torch.train import common, train_pigan
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


GEN_CFG = dict(z_dim=32, resolution=8, coarse_samples=5, fine_samples=4)
RES, BATCH, ALPHA = 8, 2, 0.5


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def models():
    """JAX generator and discriminator params, and the port's models with
    the same weights."""
    jg = jpigan.Generator(jpigan.GeneratorConfig(**GEN_CFG))
    jd = jpigan.Discriminator()
    gp, dp = jg.init(jax.random.PRNGKey(0)), jd.init(jax.random.PRNGKey(1))
    g = pigan.Generator(pigan.GeneratorConfig(**GEN_CFG))
    d = pigan.Discriminator()
    g.load_state_dict(state_dict_from_params(_np_tree(gp)))
    d.load_state_dict(state_dict_from_params(_np_tree(dp)))
    return jg, jd, gp, dp, g, d


def _jax_draws(jg, key):
    """The poses and stratified jitter ``Generator.apply`` draws from key."""
    k_pose, k_render = jax.random.split(key)
    theta, phi = jg.sample_poses(k_pose, BATCH)
    jitter = jax.random.uniform(
        k_render, (BATCH, RES * RES, GEN_CFG["coarse_samples"]), jnp.float32)
    return {"poses": (torch.from_numpy(np.array(theta)),
                      torch.from_numpy(np.array(phi))),
            "jitter": torch.from_numpy(np.array(jitter))}


class _NoUpdate:
    """An optimizer that leaves the parameters, and their .grad, as they
    are."""

    def step(self):
        pass


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grads_close(module, grads_j, gate):
    got = params_from_state_dict({n: p.grad for n, p in
                                  module.named_parameters()})
    flat_t = jax.tree_util.tree_leaves_with_path(got)
    flat_j = jax.tree_util.tree_leaves(_np_tree(grads_j))
    assert len(flat_t) == len(flat_j)
    for (path, a), b in zip(flat_t, flat_j):
        assert _rel(a, b) <= gate, (jax.tree_util.keystr(path), _rel(a, b))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    real = rng.uniform(size=(BATCH, 3, RES, RES)).astype(np.float32)
    z = rng.normal(size=(2, BATCH, GEN_CFG["z_dim"])).astype(np.float32)
    return real, z


def test_d_step_matches_jax(models):
    """d_loss, r1 and the labels at rtol 1e-5; D's gradients, through R1's
    double backward, in relative Frobenius norm <= 5e-3."""
    jg, jd, gp, dp, g, d = models
    real, z = _inputs(0)
    key = jax.random.PRNGKey(5)

    def loss_fn(dp):
        fake = jg.apply(gp, key, jnp.asarray(z[0]), RES)
        fake_label = jd.apply(dp, fake, RES, ALPHA)
        real_label = jd.apply(dp, jnp.asarray(real), RES, ALPHA)
        r1 = jtrain.r1_penalty(jd.apply, dp, jnp.asarray(real), RES, ALPHA)
        loss = (-jnp.mean(jtrain.loss_f(fake_label))
                - jnp.mean(jtrain.loss_f(-real_label)) + r1)
        return loss, {"d_loss": loss, "r1": r1,
                      "real_label": jnp.mean(real_label),
                      "fake_label": jnp.mean(fake_label)}

    (_, m_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(dp)

    d_step, _ = train_pigan.make_gan_steps(g, d, _NoUpdate(), _NoUpdate(),
                                           RES, r1_lambda=1.0)
    for p in d.parameters():
        p.grad = None
    m_t = d_step(torch.from_numpy(real), torch.from_numpy(z[0]), ALPHA,
                 **_jax_draws(jg, key))
    for k in ("d_loss", "r1", "real_label", "fake_label"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    _grads_close(d, grads_j, 5e-3)
    # the generator ran with no graph: its parameters got no gradient
    assert all(p.grad is None for p in g.parameters())


@pytest.mark.parametrize("mode,gate", [(0, 5e-3), (1, 5e-2), (None, 5e-3)])
def test_g_step_matches_jax(models, monkeypatch, mode, gate):
    """g_loss at rtol 1e-5 and G's gradients in relative Frobenius norm.
    Mode 0 (the plain trunk under autograd) is the fp32 algorithm, held at
    5e-3.  Mode 1, the card's default, backpropagates the trunk through K7's
    plain version in bf16, as the card does; bf16 operands put it ~1e-2
    from the fp32 gradients, so it is held at 5e-2.  Unset (None), CPU
    tensors take mode 0, as the JAX package does off the TPU."""
    if mode is None:
        monkeypatch.delenv("MSRA_TPU_FUSED_FILM", raising=False)
    else:
        monkeypatch.setenv("MSRA_TPU_FUSED_FILM", str(mode))
    jg, jd, gp, dp, g, d = models
    real, z = _inputs(1)
    key = jax.random.PRNGKey(6)

    def loss_fn(gp):
        fake = jg.apply(gp, key, jnp.asarray(z[1]), RES)
        return jnp.mean(jtrain.loss_f(jd.apply(dp, fake, RES, ALPHA)))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(gp)

    _, g_step = train_pigan.make_gan_steps(g, d, _NoUpdate(), _NoUpdate(),
                                           RES)
    for p in g.parameters():
        p.grad = None
    m_t = g_step(torch.from_numpy(z[1]), ALPHA, **_jax_draws(jg, key))
    np.testing.assert_allclose(float(m_t["g_loss"]), float(loss_j),
                               rtol=1e-5)
    _grads_close(g, grads_j, gate)


def test_noise_schedule_stage_of_and_lr_match_jax():
    for args in [(0.1, 100, 0.0, s) for s in (0, 1, 50, 99, 100, 500)] + \
            [(0.2, 10, 0.05, s) for s in (0, 5, 9, 10, 11)] + \
            [(0.0, 0, 0.0, 3)]:
        assert train_pigan.noise_schedule(*args) == \
            jtrain.noise_schedule(*args)
    its = [0, 5, 9]
    for step in range(0, 12):
        assert train_pigan.stage_of(step, its) == jtrain.stage_of(step, its)
    sched_t = common.interp_lr(5e-5, 1e-5, 500)
    sched_j = jcommon.interp_lr(5e-5, 1e-5, 500)
    for step in (0, 1, 1000, 500_000):
        assert sched_t(step) == pytest.approx(float(sched_j(step)),
                                              rel=1e-12)
    x = [1.0, 2.0, torch.tensor(3.0), torch.tensor([4.0, 5.0])]
    assert flush_scalar_list(list(x)) == jflush(
        [1.0, 2.0, jnp.float32(3.0), jnp.array([4.0, 5.0])])


def test_model_sizes_match_jax(capsys):
    """The full-width generator and discriminator have the JAX package's
    parameter counts (test.json's z_dim 1024)."""
    jg = jpigan.Generator(jpigan.GeneratorConfig(z_dim=1024))
    jd = jpigan.Discriminator()
    n_g = common.summary_module("generator", pigan.Generator(
        pigan.GeneratorConfig(z_dim=1024)))
    n_d = common.summary_module("discriminator", pigan.Discriminator())
    assert n_g == jcommon.summary_module("generator", jax.eval_shape(
        jg.init, jax.random.PRNGKey(0)))
    assert n_d == jcommon.summary_module("discriminator", jax.eval_shape(
        jd.init, jax.random.PRNGKey(0)))
    assert "2,107,396 total parameters" in capsys.readouterr().out


@pytest.mark.parametrize("variant", ["blobs", "shaded", "face", "bigface"])
def test_synthetic_faces_and_batches_match_jax(tmp_path, variant):
    """The same PNGs as the JAX package's, and the same (epoch, batch,
    images) sequence from ImageFolder, preloaded, streamed and prefetched."""
    a, b = tmp_path / "port", tmp_path / "jax"
    data.make_synthetic_faces(str(a), n=5, size=16, variant=variant)
    jdata.make_synthetic_faces(str(b), n=5, size=16, variant=variant)
    for f in sorted(b.iterdir()):
        assert (a / f.name).read_bytes() == f.read_bytes(), f.name
    ref = jdata.ImageFolder(str(b), 2, resize=0.5, prefetch=False)
    want = [ref.get() for _ in range(5)]
    for kw in (dict(), dict(preload=False, prefetch=False),
               dict(preload=False, prefetch=True)):
        ds = data.ImageFolder(str(a), 2, resize=0.5, **kw)
        for e, bi, imgs in want:
            got = ds.get()
            assert got[:2] == (e, bi)
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(imgs))
        ds.close()


def test_prefetch_worker_error_reaches_get(tmp_path):
    (tmp_path / "00000.png").write_bytes(b"not a png")
    ds = data.ImageFolder(str(tmp_path), 1, preload=False, prefetch=True)
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        ds.get()
    ds.close()
    assert ds._worker is None


def test_test_json_loads_in_place():
    cfg = resolve(load_config(CONFIG_ROOT + "/pi_gan/test.json"),
                  PIGAN_TRAIN_DEFAULTS)
    assert cfg["z_dim"] == 1024 and cfg["batch_size"] == [64, 16]
    assert cfg["resolution"] == [32, 64]
    assert (cfg["render_coarse_sample_num"],
            cfg["render_fine_sample_num"]) == (8, 16)
    from msra_practice_project_tpu.core.config import (
        PIGAN_TRAIN_DEFAULTS as J_DEFAULTS)
    assert PIGAN_TRAIN_DEFAULTS == J_DEFAULTS


def test_train_both_stages_checkpoint_resume_and_demo(tmp_path):
    """train(device='cpu') on tiny synthetic faces, through the stage switch
    and the fade-in: finite losses, a checkpoint and a demo grid; a second
    call resumes from the checkpoint and runs on."""
    kw = dict(output_path=str(tmp_path), experiment_name="pigan",
              data_path=str(tmp_path / "missing"), z_dim=16,
              batch_size=[2, 2], resolution=[8, 16],
              render_coarse_sample_num=3, render_fine_sample_num=4,
              fade_in_itrs=[0, 2], i_print=2, i_save=5, i_image=5, data_n=6)
    log = tmp_path / "pigan"
    K.reset_launch_counts()
    out = train_pigan.train(resolve(dict(kw, iterations=[3, 5]),
                                    PIGAN_TRAIN_DEFAULTS), device="cpu",
                            timed_steps=2)
    losses = out["loss_log"]
    assert len(losses["d_loss"]) == len(losses["g_loss"]) == 5
    assert np.isfinite(losses["d_loss"] + losses["g_loss"]).all()
    assert (log / "000005.ckpt").exists() and (log / "000005.png").exists()
    assert len(list((log / "_synthetic_faces").glob("*.png"))) == 6
    assert out["window_ms"] > 0
    # CPU tensors take the plain versions: no kernel launch is counted
    assert K.film_mlp_fwd.launches == K.film_mlp_bwd.launches == 0
    saved = ckpt.restore(str(log / "000005.ckpt"))
    assert saved["step"] == 5
    w5 = [p.detach().clone() for p in out["generator"].parameters()]

    res = train_pigan.train(resolve(dict(kw, iterations=[3, 7]),
                                    PIGAN_TRAIN_DEFAULTS), device="cpu")
    assert res["window_ms"] is None
    assert len(res["loss_log"]["g_loss"]) == 7
    np.testing.assert_array_equal(res["loss_log"]["g_loss"][:5],
                                  losses["g_loss"])
    assert np.isfinite(res["loss_log"]["d_loss"]).all()
    w7 = list(res["generator"].parameters())
    assert any(not torch.equal(a, b) for a, b in zip(w7, w5))
    assert ckpt.latest(str(log))[0] == 5

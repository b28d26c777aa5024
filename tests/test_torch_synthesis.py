"""The port's latent inversion (msra_practice_project_tpu_torch.train.
synthesis) against the JAX package's on the CPU, on a tiny generator (8x8
pixels, 4 + 4 samples) and the full discriminator with shared weights
(``weights.py``): one loss and its film gradient against JAX's own step
(its loss_fn through value_and_grad), with the step's draws injected, and
synthesize end to end with a kill and a resume."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msra_practice_project_tpu.models import pigan as jpigan
from msra_practice_project_tpu.train import synthesis as jsyn
from msra_practice_project_tpu_torch.core import ckpt as ckpt_lib
from msra_practice_project_tpu_torch.core.config import (
    PIGAN_TRAIN_DEFAULTS, log_dir, resolve, save_config)
from msra_practice_project_tpu_torch.models import pigan
from msra_practice_project_tpu_torch.train import synthesis
from msra_practice_project_tpu_torch.weights import params_from_state_dict

Z_DIM = 64


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
def tiny(monkeypatch):
    """Both packages' synthesis at 8x8 with 4 + 4 samples."""
    for mod in (synthesis, jsyn):
        monkeypatch.setattr(mod, "RESOLUTION", 8)
        monkeypatch.setattr(mod, "COARSE", 4)
        monkeypatch.setattr(mod, "FINE", 4)


def _grad_capture():
    """An optax transformation that leaves the params and keeps the
    gradient as its state."""
    return optax.GradientTransformation(
        init=jnp.zeros_like, update=lambda g, s, p=None: (jnp.zeros_like(g),
                                                          g))


def _rel_frob(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mode", [0, 1])
def test_syn_loss_and_dfilm_match_jax(tiny, mode, monkeypatch):
    """Mode 0 (plain autograd): the loss at 1e-5 and dfilm at 1e-4 in
    relative Frobenius norm.  Mode 1 (K8 in fp32 forward, K7 in bf16
    backward, their plain versions on the CPU): the loss at 1e-5, dfilm at
    K7's bf16 gate, 5e-2."""
    monkeypatch.setenv("MSRA_TPU_FUSED_FILM", str(mode))
    init = torch.Generator().manual_seed(1)
    g = pigan.Generator(pigan.GeneratorConfig(z_dim=Z_DIM, resolution=8,
                                              coarse_samples=4,
                                              fine_samples=4),
                        generator=init)
    d = pigan.Discriminator(generator=init)
    g.requires_grad_(False)
    d.requires_grad_(False)
    jg = jpigan.Generator(jpigan.GeneratorConfig(z_dim=Z_DIM, resolution=8,
                                                 coarse_samples=4,
                                                 fine_samples=4))
    jd = jpigan.Discriminator()
    gp, dp = (params_from_state_dict(m.state_dict()) for m in (g, d))
    rng = np.random.default_rng(mode)
    target = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    z = rng.normal(size=(1, Z_DIM)).astype(np.float32)
    with torch.no_grad():
        film0 = g.get_mapping(torch.from_numpy(z))[0]

    key = jax.random.PRNGKey(11)
    step, _ = jsyn.make_syn_step(jg, jd, gp, dp, jnp.asarray(target),
                                 _grad_capture())
    film_j = jnp.asarray(film0.numpy())
    state = {"params": film_j, "opt_state": jnp.zeros_like(film_j),
             "step": 0}
    new, m = step(state, key)
    grad_ref, loss_ref = np.asarray(new["opt_state"]), float(m["loss"])

    k1, k2, k3 = jax.random.split(key, 3)
    theta, phi = jg.sample_poses(k2, 1)
    draws = tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(k1, (1, 64, 4), jnp.float32), theta, phi,
        jax.random.uniform(k3, (1, 64, 4), jnp.float32)))
    film = film0.clone().requires_grad_(True)
    loss, aux = synthesis.syn_loss(g, d, film, torch.from_numpy(target),
                                   draws=(draws[0], draws[1:3], draws[3]))
    (grad,) = torch.autograd.grad(loss, [film])
    assert grad.shape == (9, 512)
    assert float(loss.detach()) == pytest.approx(loss_ref, rel=1e-5)
    assert float(aux["rec"]) == pytest.approx(float(m["rec"]), rel=1e-5)
    assert float(aux["g"]) == pytest.approx(float(m["g"]), rel=1e-5)
    err = _rel_frob(grad.numpy(), grad_ref)
    assert err <= (1e-4 if mode == 0 else 5e-2), err


def make_experiment(root):
    """A tiny experiment as train_pigan leaves it: config.json and a
    checkpoint of random G and D."""
    cfg = resolve({"output_path": str(root), "experiment_name": "exp",
                   "z_dim": Z_DIM, "render_coarse_sample_num": 4,
                   "render_fine_sample_num": 4}, PIGAN_TRAIN_DEFAULTS)
    save_config(cfg, log_dir(cfg))
    init = torch.Generator().manual_seed(0)
    g = pigan.Generator(pigan.GeneratorConfig(z_dim=Z_DIM), generator=init)
    d = pigan.Discriminator(generator=init)
    ckpt_lib.save(log_dir(cfg), 5, {"g": g.state_dict(),
                                    "d": d.state_dict(), "step": 5})
    return cfg


def test_synthesize_resumes_and_continues_the_loss_log(tiny, tmp_path,
                                                       monkeypatch, capsys):
    """Self-inversion of a generated sample: 4 steps straight through,
    against 3 steps (a kill after the step-2 checkpoint) and a resume to 4,
    which restores the film and Adam from step 2, truncates the loss log
    to the checkpoint and draws what the straight run drew: the same loss
    log and film, bitwise.  Each run writes its checkpoints, the loss
    sidecar, the multiview grids and the orbit GIF."""
    monkeypatch.delenv("MSRA_TPU_FUSED_FILM", raising=False)
    for k, v in dict(FINAL_RES=8, FINAL_COARSE=2, FINAL_FINE=2, I_PRINT=1,
                     I_SAVE=2, I_IMAGE=4).items():
        monkeypatch.setattr(synthesis, k, v)
    monkeypatch.setattr(synthesis, "demo_multiview", _small_multiview(
        synthesis.demo_multiview))
    straight = make_experiment(tmp_path / "a")
    ref = synthesis.synthesize(dict(straight, syn_iterations=4),
                               device="cpu")
    assert "inverting a generated sample" in capsys.readouterr().out
    assert len(ref["loss_log"]) == 4 and all(
        np.isfinite(ref["loss_log"]))
    assert ref["target"].shape == (8, 8, 3)

    cfg = make_experiment(tmp_path / "b")
    first = synthesis.synthesize(dict(cfg, syn_iterations=3), device="cpu")
    assert first["loss_log"][:3] == ref["loss_log"][:3]
    syn_dir = first["log_path"]
    assert [s for s, _ in ckpt_lib.list_checkpoints(syn_dir)] == [2]
    assert np.load(os.path.join(syn_dir, "syn_loss.npy")).tolist() == \
        ref["loss_log"][:2]
    out = synthesis.synthesize(dict(cfg, syn_iterations=4), device="cpu")
    assert "Reloading from" in capsys.readouterr().out
    assert out["loss_log"] == ref["loss_log"]
    assert torch.equal(out["film"], ref["film"])
    assert [s for s, _ in ckpt_lib.list_checkpoints(syn_dir)] == [2, 4]
    for f in ("000004.png", "demo.png", "demo.gif"):
        assert os.path.exists(os.path.join(syn_dir, f)), f


def _small_multiview(demo_multiview):
    """The step-I_IMAGE multiview at 2 + 2 samples (synthesis renders it
    with the demo's 32 + 64)."""
    def small(gen_model, file_name, poses, rows=4, film=None,
              resolution=None, coarse=None, fine=None, **kw):
        return demo_multiview(gen_model, file_name, poses, rows, film,
                              resolution, 2, 2, **kw)
    return small

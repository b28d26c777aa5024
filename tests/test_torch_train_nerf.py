"""The port's NeRF train step and trainer
(msra_practice_project_tpu_torch.train) against the JAX package, on the CPU.

One step at full model width (and a small batch) must match
``_make_step_impl`` with the same weights, batch and stratified jitter: the
JAX step on the CPU uses the plain model, and so does the port's."""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msra_practice_project_tpu_torch as port
from msra_practice_project_tpu.core.config import (
    NERF_TRAIN_DEFAULTS as J_DEFAULTS)
from msra_practice_project_tpu.models.nerf import nerf_model as jnerf_model
from msra_practice_project_tpu.train import common as jcommon
from msra_practice_project_tpu.train.train_nerf import _make_step_impl
from msra_practice_project_tpu_torch.core import ckpt
from msra_practice_project_tpu_torch.core.config import (
    CONFIG_ROOT, NERF_TRAIN_DEFAULTS, load_config, resolve)
from msra_practice_project_tpu_torch.models.nerf import nerf_model
from msra_practice_project_tpu_torch.train import common, train_nerf
from msra_practice_project_tpu_torch.weights import (
    nerf_params_from_state_dict, nerf_state_dict)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and idle OpenMP workers
    spinning after every op would take cores from the other processes of a
    parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rng, n):
    ro = rng.normal(size=(n, 3)) * 0.1 + [0, 0, 4.0]
    rd = -ro / np.linalg.norm(ro, axis=-1, keepdims=True) \
        + 0.1 * rng.normal(size=(n, 3))
    rgba = rng.uniform(size=(n, 4))
    return np.concatenate([ro, rd, rgba], 1).astype(np.float32)


def _port_models(params):
    models = {}
    for name, p in params.items():
        if p is not None:
            models[name] = nerf_model()
            models[name].load_state_dict(
                nerf_state_dict(jax.tree_util.tree_map(np.asarray, p)))
    return models


def _leaves(model):
    return jax.tree_util.tree_leaves(
        nerf_params_from_state_dict(model.state_dict()))


@pytest.mark.parametrize("use_fine,use_alpha",
                         [(True, False), (True, True), (False, True)])
def test_one_step_matches_jax_step(use_fine, use_alpha):
    """9 coarse and 17 fine samples make both linspaces exact, so the coarse
    points are bitwise equal in the two frameworks.  The fine samples are
    not: sample_pdf's cumsum rounds in another order in JAX, and the 2^9 PE
    frequency turns those last bits into visible differences in the fine
    pass's gradients.  So:
    metrics at rtol 1e-5, gradients in relative Frobenius norm, and Adam on
    identical gradients at atol 1e-6 (its first step is ~lr*sign(g), so a
    gradient that is ~0 in one framework and ~1e-8 in the other would move
    a parameter by lr)."""
    cfg = dict(J_DEFAULTS, use_fine_model=use_fine, use_alpha=use_alpha,
               render_coarse_sample_num=9, render_fine_sample_num=17)
    jm = jnerf_model(False)
    params = {"coarse": jm.init(jax.random.PRNGKey(0)),
              "fine": jm.init(jax.random.PRNGKey(1)) if use_fine else None}
    tx = jcommon.adam(jcommon.exponential_lr(5e-4, 500))
    state = jcommon.init_state(params, tx)
    batch = _batch(np.random.default_rng(0), 32)
    key = jax.random.PRNGKey(7)
    new_state, m_j = _make_step_impl(jm, jm, tx, cfg)(
        state, jnp.asarray(batch), key)
    grads_j = jax.tree_util.tree_map(          # Adam's mu = (1 - b1) g
        lambda mu: np.asarray(mu) / 0.1, new_state["opt_state"][0].mu)

    models = _port_models(params)
    opt = common.adam([p for m in models.values() for p in m.parameters()],
                      common.exponential_lr(5e-4, 500))
    step = train_nerf.make_train_step(models["coarse"],
                                      models.get("fine", models["coarse"]),
                                      opt, cfg, device="cpu")
    jitter = torch.from_numpy(np.array(
        jax.random.uniform(key, (32, 9), jnp.float32)))
    m_t = step(torch.from_numpy(batch), jitter=jitter)

    for k in ("loss", "loss_coarse", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    for name, model in models.items():
        g_t = jax.tree_util.tree_leaves(nerf_params_from_state_dict(
            {k: p.grad for k, p in model.named_parameters()}))
        for a, b in zip(jax.tree_util.tree_leaves(grads_j[name]), g_t):
            rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
            assert rel < 5e-3, (name, rel)

    # Adam with the learning-rate schedule, on the JAX step's gradients
    models = _port_models(params)
    opt = common.adam([p for m in models.values() for p in m.parameters()],
                      common.exponential_lr(5e-4, 500))
    for name, model in models.items():
        g = _port_models({"x": grads_j[name]})["x"]
        for p, gp in zip(model.parameters(), g.parameters()):
            p.grad = gp.detach().clone()
    opt.step()
    for name, model in models.items():
        want = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, new_state["params"][name]))
        for a, b in zip(want, _leaves(model)):
            np.testing.assert_allclose(b, a, atol=1e-6)


def test_exponential_lr_counts_updates_like_optax():
    sched = common.exponential_lr(5e-4, 500)
    assert sched(0) == 5e-4
    assert sched(500_000) == pytest.approx(5e-5)
    p = torch.nn.Parameter(torch.ones(3))
    opt = common.adam([p], sched)
    for _ in range(3):
        p.grad = torch.ones(3)
        opt.step()
    assert opt.count == 3
    assert opt.opt.param_groups[0]["lr"] == sched(2)


def test_train_smoke_checkpoint_and_resume(tmp_path, monkeypatch):
    common_kw = dict(output_path=str(tmp_path), experiment_name="nerf",
                     data_path="/nonexistent", batch_size=64,
                     start_up_itrs=3, render_coarse_sample_num=4,
                     render_fine_sample_num=8, i_print=100, i_save=6,
                     i_image=6, data_size=16)
    log = tmp_path / "nerf"
    steps, seen = [], []
    make_step = train_nerf.make_train_step

    def counting_step(*args):
        step = make_step(*args)
        return lambda *a, **k: (steps.append(1), step(*a, **k))[1]

    @contextlib.contextmanager
    def window():
        seen.append((len(steps), len(list(log.glob("*.ckpt")))))
        yield
        seen.append((len(steps), len(list(log.glob("*.ckpt")))))

    monkeypatch.setattr(train_nerf, "make_train_step", counting_step)
    out = train_nerf.train(resolve(dict(common_kw, iterations=6),
                                   NERF_TRAIN_DEFAULTS), device="cpu",
                           timed_steps=4, window=window())
    assert np.isfinite(out["log"]["loss"]).all()
    assert (log / "000006.ckpt").exists() and (log / "000006.png").exists()
    # the window holds steps 3..6 and closes before step 6's checkpoint
    assert seen == [(2, 0), (6, 0)] and out["window_ms"] > 0
    monkeypatch.undo()
    saved = ckpt.restore(str(log / "000006.ckpt"))
    assert saved["step"] == 6 and saved["opt"]["count"] == 6
    w6 = [p.detach().clone() for m in out["models"] for p in m.parameters()]

    res = train_nerf.train(resolve(dict(common_kw, iterations=9),
                                   NERF_TRAIN_DEFAULTS), device="cpu")
    assert res["window_ms"] is None
    assert res["state"]["step"] == 9 and res["state"]["opt"].count == 9
    assert len(res["log"]["loss"]) == 9
    np.testing.assert_array_equal(res["log"]["loss"][:6], out["log"]["loss"])
    w9 = [p.detach() for m in res["models"] for p in m.parameters()]
    assert any(not torch.equal(a, b) for a, b in zip(w9, w6))
    assert ckpt.latest(str(log))[0] == 6


def test_lego_config_loads_in_place():
    cfg = resolve(load_config(os.path.join(CONFIG_ROOT, "nerf", "lego.json")),
                  NERF_TRAIN_DEFAULTS)
    assert cfg["batch_size"] == 1024
    assert (cfg["render_coarse_sample_num"],
            cfg["render_fine_sample_num"]) == (64, 128)
    assert cfg["use_fused_mlp"] and cfg["steps_per_call"] == 10
    assert set(J_DEFAULTS) == set(NERF_TRAIN_DEFAULTS)
    assert common.parse_cli(
        [os.path.join(CONFIG_ROOT, "nerf", "lego.json"), "iterations=7",
         "experiment_name=x"], NERF_TRAIN_DEFAULTS)["iterations"] == 7


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """device=None means CUDA: without a card the entry points raise and
    never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_nerf.train(resolve(dict(output_path=str(tmp_path),
                                      experiment_name="x"),
                                 NERF_TRAIN_DEFAULTS))
    assert port.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("override", [dict(use_fused_mlp=False),
                                      dict(use_siren=True)])
def test_cuda_step_has_no_plain_route(override):
    """On CUDA the MLP runs through the fused kernels or the step raises;
    the plain model is the CPU's route only."""
    m = nerf_model()
    opt = common.adam(list(m.parameters()), common.exponential_lr(5e-4, 500))
    cfg = dict(NERF_TRAIN_DEFAULTS, **override)
    with pytest.raises(NotImplementedError, match="fused kernels"):
        train_nerf.make_train_step(m, m, opt, cfg, "cuda")
    assert callable(train_nerf.make_train_step(m, m, opt, cfg, "cpu"))

"""The port's data parallelism (msra_practice_project_tpu_torch.parallel.mesh,
the four trainers' steps, ops.render.render_image_sharded, dryrun) on the
CPU, over gloo ranks that ``mesh.spawn`` starts with a file store.

The spawned targets are the port's own functions (``dryrun.nerf_steps``
and its siblings), so the child processes never import JAX.  Each DP run
is held against the same function in this process without a group, as
tests/test_parallel.py holds the JAX package's sharded step against its
single-device step: losses at 1e-5 relative, gradients at 2e-5.  Later
steps are compared at the DP run's own weights (``at=``): Adam's first
steps are about lr * sign(g), so two trajectories part by up to lr on
gradients near 0 whatever the reduction order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.core.config import (
    NERF_TRAIN_DEFAULTS as J_DEFAULTS)
from msra_practice_project_tpu.models.nerf import nerf_model as jnerf_model
from msra_practice_project_tpu.ops import rays as jrays
from msra_practice_project_tpu.ops.render import (
    render_image_sharded as jrender_image_sharded)
from msra_practice_project_tpu.parallel import mesh as jmesh
from msra_practice_project_tpu.train import common as jcommon
from msra_practice_project_tpu.train.train_nerf import make_train_step
from msra_practice_project_tpu_torch import dryrun
from msra_practice_project_tpu_torch.core.config import (
    NERF_TRAIN_DEFAULTS, PIGAN_TRAIN_DEFAULTS, resolve)
from msra_practice_project_tpu_torch.models.nerf import nerf_model
from msra_practice_project_tpu_torch.ops import rays as ray_ops
from msra_practice_project_tpu_torch.ops.render import render_image
from msra_practice_project_tpu_torch.parallel import mesh
from msra_practice_project_tpu_torch.weights import (
    params_from_state_dict, state_dict_from_params)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in every spawned rank: CPU matmuls round by
    their thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(n, seed=2):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((n, 3), generator=g)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4.0 + 0.15 * torch.randn((n, 3), generator=g)
    return torch.cat([o, d, torch.rand((n, 4), generator=g)], dim=1)


def _close(got, want, atol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol)


def test_dp_nerf_steps_match_one_process():
    """Two NeRF steps over 2 ranks: the first step's loss and averaged
    gradients as one process computes them; the second step's loss in
    step with the one process's run (1e-4, tests/test_parallel.py's sync
    gate), its gradients at the DP run's weights at 2e-5; both ranks hold
    equal weights."""
    batch = _rays(64)
    dp = mesh.spawn(dryrun.nerf_steps, 2, args=(batch, 2, 0, 4, 8, "cpu"))
    one = dryrun.nerf_steps(batch, 2, device="cpu")
    at = dryrun.nerf_steps(batch, 2, device="cpu", at=dp[0]["before"])
    np.testing.assert_allclose(dp[0]["loss"][0], one["loss"][0], rtol=1e-5)
    _close(dp[0]["grads"][0], one["grads"][0], 2e-5)
    np.testing.assert_allclose(dp[0]["loss"], one["loss"], rtol=1e-4)
    np.testing.assert_allclose(dp[0]["loss"], at["loss"], rtol=1e-5)
    _close(dp[0]["grads"][1], at["grads"][1], 2e-5)
    assert dp[0]["loss"] == dp[1]["loss"]
    assert all(torch.equal(a, b) for a, b in zip(dp[0]["params"],
                                                 dp[1]["params"]))


def test_dp_nerf_step_matches_jax_sharded_step():
    """One step over 2 ranks against the JAX package's step with its batch
    sharded over the 8-device mesh, from the same weights with the JAX
    draws' jitter: metrics at 1e-5, gradients at 5e-3 relative Frobenius
    norm (the fine pass's 2^9 PE frequency, as test_torch_train_nerf.py
    holds the single-process step)."""
    cfg = dict(J_DEFAULTS, use_fine_model=True, use_alpha=True,
               render_coarse_sample_num=9, render_fine_sample_num=17)
    jm = jnerf_model(False)
    params = {"coarse": jm.init(jax.random.PRNGKey(0)),
              "fine": jm.init(jax.random.PRNGKey(1))}
    models = [nerf_model(False) for _ in range(2)]
    for m, k in zip(models, ("coarse", "fine")):
        m.load_state_dict(state_dict_from_params(
            jax.tree_util.tree_map(np.asarray, params[k])))
    tx = jcommon.adam(jcommon.exponential_lr(5e-4, 500))
    dp_mesh = jmesh.make_mesh(8)
    state = jmesh.replicate(jcommon.init_state(params, tx), dp_mesh)
    rng = np.random.default_rng(0)     # test_torch_train_nerf.py's batch
    ro = rng.normal(size=(32, 3)) * 0.1 + [0, 0, 4.0]
    rd = -ro / np.linalg.norm(ro, axis=-1, keepdims=True) \
        + 0.1 * rng.normal(size=(32, 3))
    batch = torch.from_numpy(np.concatenate(
        [ro, rd, rng.uniform(size=(32, 4))], 1).astype(np.float32))
    key = jax.random.PRNGKey(7)
    new_state, m_j = make_train_step(jm, jm, tx, cfg)(
        state, jax.device_put(jnp.asarray(batch.numpy()),
                              jmesh.batch_sharding(dp_mesh)), key)
    grads_j = [np.asarray(mu) / 0.1 for name in ("coarse", "fine")
               for mu in jax.tree_util.tree_leaves(
                   new_state["opt_state"][0].mu[name])]
    jitter = torch.from_numpy(np.array(
        jax.random.uniform(key, (32, 9), jnp.float32)))

    at = [[p.detach().clone() for m in models for p in m.parameters()]]
    dp = mesh.spawn(dryrun.nerf_steps, 2, args=(batch, 1, 0, 9, 17, "cpu",
                                                at, [jitter]))[0]
    np.testing.assert_allclose(dp["loss"][0], float(m_j["loss"]), rtol=1e-5)
    np.testing.assert_allclose(dp["psnr"][0], float(m_j["psnr"]), rtol=1e-5)
    grads = iter(dp["grads"][0])        # the models' parameter order
    got = []
    for m in models:
        sd = {n: next(grads) for n, _ in m.named_parameters()}
        got += jax.tree_util.tree_leaves(params_from_state_dict(sd))
    for a, b in zip(got, grads_j):
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel < 5e-3, rel


@pytest.mark.parametrize("aug,noise", [("", False),
                                       ("color,translation,cutout", True)])
def test_dp_pigan_across_a_stage_switch_matches_one_process(aug, noise):
    """Two iterations at 8x8 and two at 16x16 with the fade-in, over 2
    ranks of 2 images each, against one process at the DP run's weights
    (the first iteration's are the initial ones): every loss at 1e-5 and
    every D and G step's averaged gradients at 2e-5 (instance noise and
    DiffAugment drawn for the whole batch on every rank), Adam counts
    carried, equal replicas."""
    dp = mesh.spawn(dryrun.pigan_steps, 2,
                    args=(4, ((8, 2), (16, 2)), 64, (2, 4), 0, "cpu", aug,
                          noise))
    at = dryrun.pigan_steps(4, device="cpu", diff_augment=aug,
                            instance_noise=noise, at=dp[0]["before"])
    for k in ("d_loss", "g_loss", "r1"):
        np.testing.assert_allclose(dp[0][k], at[k], rtol=1e-5, atol=1e-6)
    for k in ("d_grads", "g_grads"):
        for got, want in zip(dp[0][k], at[k]):
            _close(got, want, 2e-5)
    assert dp[0]["count"] == dp[1]["count"] == (4, 4)
    assert all(torch.equal(a, b) for a, b in zip(dp[0]["params"],
                                                 dp[1]["params"]))


@pytest.mark.parametrize("kind", ["img", "sdf"])
def test_dp_siren_step_matches_one_process(kind):
    """One SIREN step over 2 ranks: the loss at 1e-5 and the averaged
    gradients at 2e-5 of the largest gradient (the SDF loss's terms weigh
    up to 3e3, so its gradients reach ~1e3)."""
    dp = mesh.spawn(dryrun.siren_step, 2, args=(kind, 64, 0, "cpu"))
    one = dryrun.siren_step(kind, 64, device="cpu")
    np.testing.assert_allclose(dp[0]["loss"], one["loss"], rtol=1e-5)
    scale = max(1.0, max(float(g.abs().max()) for g in one["grads"]))
    _close(dp[0]["grads"], one["grads"], 2e-5 * scale)
    assert all(torch.equal(a, b) for a, b in zip(dp[0]["params"],
                                                 dp[1]["params"]))


def _smooth_field():
    """A smooth field (no positional encoding; rgb and sigma in (0, 1)) of
    torch's own modules, so a spawned rank unpickles it without importing
    this file: the port and JAX agree on it to fp32 roundoff, where the
    full-width NeRF's 2^9 PE frequency turns an ulp in a sample point into
    visible differences."""
    torch.manual_seed(4)
    return torch.nn.Sequential(torch.nn.Linear(6, 16, bias=False),
                               torch.nn.Tanh(),
                               torch.nn.Linear(16, 4, bias=False),
                               torch.nn.Sigmoid())


def _smooth_jax(field):
    w1, w2 = (jnp.asarray(field[i].weight.detach().numpy()) for i in (0, 2))
    return jax.tree_util.Partial(
        lambda w1, w2, x: jax.nn.sigmoid(jnp.tanh(x @ w1.T) @ w2.T), w1, w2)


@pytest.mark.parametrize("width,height", [(20, 15), (21, 15)])
def test_render_image_sharded_matches_render_image_and_jax(width, height):
    """20x15 at chunk 25 over 2 ranks (tests/test_parallel.py's case: 300
    rays, 6 tiles a rank) and 21x15 (315 rays padded to 350): the
    full-width NeRF's view equal to the port's render_image bitwise, with
    perturb False and with the same generator's jitter; a smooth field's
    within 1e-5 of the JAX package's render_image_sharded on the 8-device
    mesh."""
    nerf = nerf_model(False, generator=torch.Generator().manual_seed(3))
    smooth = _smooth_field()
    cases = [(nerf, False, 4, 8, 3), (nerf, True, 4, 8, 3),
             (smooth, False, 8, 8, 0)]
    dp = mesh.spawn(dryrun.sharded_views, 2,
                    args=(width, height, 25, cases, "cpu"))
    assert all(torch.equal(a, b) for va, vb in zip(*dp)
               for a, b in zip(va, vb))
    pose = ray_ops.camera_pose_deg(4.0, 30.0, -30.0)
    for (model, perturb, nc, nf, seed), got in zip(cases[:2], dp[0]):
        gen = torch.Generator().manual_seed(seed)
        want = render_image(width, height, 18.0, pose, 2.0, 6.0, model,
                            model, nc, nf, chunk=25, perturb=perturb,
                            generator=gen)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    fn = _smooth_jax(smooth)
    jout = jrender_image_sharded(
        jax.random.PRNGKey(0), width, height, 18.0,
        jrays.camera_pose_deg(4.0, 30.0, -30.0), 2.0, 6.0, fn, fn, 8, 8,
        mesh=jmesh.make_mesh(8), chunk=25, perturb=False)
    for a, b in zip(dp[0][2], jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_dryrun_multichip_prints_its_ok_lines(capsys):
    lines = dryrun.dryrun_multichip(2, "cpu")
    out = capsys.readouterr().out
    for tag in ("nerf", "pigan", "pigan stage switch",
                "sharded render_image", "siren img DP", "siren sdf DP"):
        assert f"dryrun_multichip OK ({tag})" in out
    assert len(lines) == 6


@pytest.mark.parametrize("call", [
    lambda: dryrun.nerf_steps(_rays(8), 1),
    lambda: dryrun.pigan_steps(2),
    lambda: dryrun.siren_step("img", 8),
    lambda: dryrun.sharded_views(4, 4, 8, []),
    lambda: dryrun.run_trainer("train_nerf", {}),
    lambda: dryrun.dryrun_multichip(2),
], ids=["nerf_steps", "pigan_steps", "siren_step", "sharded_views",
        "run_trainer", "dryrun_multichip"])
def test_dryrun_drivers_default_to_the_card(call, monkeypatch):
    """Like every entry point of the port, the dry run and its drivers run
    on CUDA unless asked for the CPU: without a card they raise before any
    work rather than quietly running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        call()


def test_dp_pigan_trainer_across_a_stage_switch(tmp_path):
    """train_pigan.train over 2 ranks through both stages (8x8 then 16x16
    with fade-in, batch 4): finite losses, every logged loss of the first
    iteration as one process logs it, and rank 0's checkpoint."""
    cfg = dict(output_path=str(tmp_path), data_path="/nonexistent",
               z_dim=32, render_coarse_sample_num=2,
               render_fine_sample_num=4, iterations=[2, 4],
               fade_in_itrs=[0, 2], batch_size=[4, 4], resolution=[8, 16],
               i_print=100, i_save=4, i_image=100, data_n=8)
    dp = mesh.spawn(dryrun.run_trainer, 2, args=(
        "train_pigan", resolve(dict(cfg, experiment_name="dp"),
                               PIGAN_TRAIN_DEFAULTS), "cpu"))
    one = dryrun.run_trainer("train_pigan", resolve(
        dict(cfg, experiment_name="one"), PIGAN_TRAIN_DEFAULTS), "cpu")
    assert dp[0] == dp[1]
    for k in ("d_loss", "g_loss"):
        assert len(dp[0][k]) == 4 and np.isfinite(dp[0][k]).all()
        np.testing.assert_allclose(dp[0][k][0], one[k][0], rtol=1e-5)
    assert (tmp_path / "dp" / "000004.ckpt").exists()


def test_dp_refuses_a_batch_that_does_not_divide(tmp_path):
    """A 2-rank run whose batch does not split raises rather than running
    the whole batch on both ranks."""
    cfg = resolve(dict(output_path=str(tmp_path), experiment_name="odd",
                       data_path="/nonexistent", iterations=1, batch_size=63,
                       start_up_itrs=0, render_coarse_sample_num=4,
                       render_fine_sample_num=4, data_size=8),
                  NERF_TRAIN_DEFAULTS)
    with pytest.raises(Exception, match="do not divide over 2 ranks"):
        mesh.spawn(dryrun.run_trainer, 2, args=("train_nerf", cfg, "cpu"))


def test_init_from_env_needs_a_card_per_rank_or_a_named_backend(
        monkeypatch):
    """Outside torchrun no group is joined; a layout NCCL cannot serve
    (here: no card) raises unless a backend is named."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_from_env() is False
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                 ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass the backend 'gloo'"):
        mesh.init_from_env()
    assert not mesh.initialized() and mesh.world() == 1
    x = torch.arange(6)
    assert mesh.local_slice(x) is x
    assert mesh.all_reduce_grads([], torch.tensor(1.0))[0] == 1.0

"""The plain references against the program's CPU path at small sizes, and
their own parts (the operand rounding, Adam) against what they stand for."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import compare, inputs
from benchmark.harness.registry import Registry
from benchmark.reference import adam as ref_adam
from benchmark.reference import nerf as ref_nerf
from benchmark.reference import pigan as ref_pigan
from benchmark.reference.precision import linear, round_to

REG = Registry()
NERF = REG.config("nerf_lego")
PIGAN = REG.config("pigan_test")
CPU = torch.device("cpu")


def _weights(specs, seed=5):
    return inputs.make_weights(specs, inputs.generator(CPU, seed, 1), CPU)


def _load(module, weights, prefix):
    module.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                            if k.startswith(prefix)})
    return module


def test_round_to():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 3.0])
    assert round_to(x, "tf32").tolist() == [1.0, 1.0 + 2.0 ** -9, 3.0]
    assert round_to(x, "bf16")[2] == 3.0
    y = torch.linspace(-1.0, 1.0, 101)
    err = (round_to(y, "fp8") - y).abs().max()
    assert 0 < err <= 2.0 ** -4
    assert torch.equal(round_to(y, "fp32"), y)


def test_rounded_linear_gradients_at_fp32_match_autograd():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 7, generator=g, requires_grad=True)
    w = torch.randn(3, 7, generator=g, requires_grad=True)
    b = torch.randn(3, generator=g, requires_grad=True)
    y = linear(x, w, b, "tf32", "bf16")
    y.square().sum().backward()
    got = [t.grad.clone() for t in (x, w, b)]
    for t in (x, w, b):
        t.grad = None
    torch.nn.functional.linear(x, w, b).square().sum().backward()
    for a, t in zip(got, (x, w, b)):
        assert torch.allclose(a, t.grad, rtol=2e-2, atol=2e-2)


def test_adam_matches_torch():
    p = torch.randn(10, generator=torch.Generator().manual_seed(1))
    mine = {"p": p.clone()}
    opt = ref_adam.Adam(mine, lambda c: 1e-3 * (c + 1), betas=(0.0, 0.9))
    t = p.clone().requires_grad_(True)
    topt = torch.optim.Adam([t], lr=1e-3, betas=(0.0, 0.9), eps=1e-8)
    for step in range(3):
        g = torch.randn(10, generator=torch.Generator().manual_seed(step))
        opt.step({"p": g})
        topt.param_groups[0]["lr"] = 1e-3 * (step + 1)
        t.grad = g.clone()
        topt.step()
    assert torch.allclose(mine["p"], t.detach(), rtol=1e-6, atol=1e-7)


def test_nerf_mlp_and_render_match_the_port():
    from msra_practice_project_tpu_torch.models.nerf import nerf_model
    from msra_practice_project_tpu_torch.ops.render import render_rays

    w = _weights(ref_nerf.param_specs(NERF))
    models = {n: _load(nerf_model(False), w, n + ".")
              for n in ("coarse", "fine")}
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 6, generator=g)
    assert torch.allclose(models["coarse"](x),
                          ref_nerf.mlp(w, "coarse", x, NERF["net"]),
                          atol=1e-6)
    rays_o = torch.randn(32, 3, generator=g) * 0.1 + torch.tensor(
        [0.0, 0.0, 4.0])
    rays_d = torch.randn(32, 3, generator=g) * 0.2 + torch.tensor(
        [0.0, 0.0, -1.0])
    jitter = torch.rand(32, 64, generator=g)
    with torch.no_grad():
        got = render_rays(rays_o, rays_d, 2.0, 6.0, models["coarse"],
                          models["fine"], 64, 128, jitter=jitter)
        (c_rgb, _, _), (f_rgb, f_depth, f_acc) = ref_nerf.render_rays(
            w, NERF["net"], rays_o, rays_d, jitter, 2.0, 6.0, 64, 128)
    assert torch.allclose(got["rgb_coarse"], c_rgb, atol=1e-5)
    assert torch.allclose(got["rgb_fine"], f_rgb, atol=1e-5)
    assert torch.allclose(got["depth_fine"], f_depth, atol=1e-4)
    assert torch.allclose(got["acc_fine"], f_acc, atol=1e-5)


def test_nerf_train_step_matches_the_port():
    from msra_practice_project_tpu_torch.models.nerf import nerf_model
    from msra_practice_project_tpu_torch.train import common
    from msra_practice_project_tpu_torch.train.train_nerf import \
        make_train_step

    w = _weights(ref_nerf.param_specs(NERF), seed=8)
    models = {n: _load(nerf_model(False), w, n + ".")
              for n in ("coarse", "fine")}
    opt = common.adam([p for m in models.values() for p in m.parameters()],
                      common.exponential_lr(5e-4, 500))
    step = make_train_step(models["coarse"], models["fine"], opt, NERF, CPU)
    trainer = ref_nerf.Trainer(w, NERF, chunk=16)
    g = torch.Generator().manual_seed(4)
    for _ in range(2):
        batch = torch.cat([torch.randn(32, 3, generator=g) * 0.1
                           + torch.tensor([0.0, 0.0, 4.0]),
                           torch.randn(32, 3, generator=g) * 0.2
                           + torch.tensor([0.0, 0.0, -1.0]),
                           torch.rand(32, 4, generator=g)], dim=1)
        jitter = torch.rand(32, 64, generator=g)
        got = float(step(batch, jitter=jitter)["loss"])
        want = float(trainer.step(batch, jitter))
        assert got == pytest.approx(want, rel=1e-5)
    leaves = {f"{n}.{k}": p.detach() for n, m in models.items()
              for k, p in m.named_parameters()}
    # Adam moves a leaf's near-zero gradients by lr either way, so the
    # leaves agree in the norm of their change
    assert compare.leaf_gap(compare.change(leaves, w),
                            compare.change(trainer.leaves(), w)) < 1e-3


@pytest.fixture
def plain_pigan(monkeypatch):
    """The port's pi-GAN on its plain path with the exact sine."""
    from msra_practice_project_tpu_torch.core import nn as core_nn
    from msra_practice_project_tpu_torch.models import pigan

    monkeypatch.setenv("MSRA_TPU_FUSED_FILM", "0")
    monkeypatch.setattr(core_nn, "USE_FAST_SIN", False)
    g = PIGAN["generator"]
    gen = pigan.Generator(pigan.GeneratorConfig(
        z_dim=PIGAN["z_dim"], resolution=8, fov=g["fov"], coarse_samples=8,
        fine_samples=16))
    w = _weights(ref_pigan.param_specs(PIGAN), seed=9)
    _load(gen, w, "g.")
    disc = _load(pigan.Discriminator(), w, "d.")
    return gen, disc, w


def test_pigan_generator_matches_the_port(plain_pigan):
    gen, _, w = plain_pigan
    g = torch.Generator().manual_seed(6)
    z = torch.randn(2, PIGAN["z_dim"], generator=g)
    theta, phi = torch.randn(2, generator=g) * 0.45, torch.randn(
        2, generator=g) * 0.15
    jitter = torch.rand(2, 64, 8, generator=g)
    film = ref_pigan.mapping(w, z, 9)
    assert torch.allclose(gen.get_mapping(z), film, atol=1e-6)
    x = torch.randn(2, 10, 6, generator=g)
    assert torch.allclose(gen.trunk(x, film),
                          ref_pigan.trunk(w, x, film, PIGAN), atol=2e-5)
    with torch.no_grad():
        got = gen(z, 8, poses=(theta, phi), jitter=jitter)
        want = ref_pigan.render(w, film, theta, phi, jitter, 8, PIGAN)
    assert torch.allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("res,alpha", [(32, -1.0), (64, 0.5), (8, -1.0)])
def test_pigan_discriminator_matches_the_port(plain_pigan, res, alpha):
    _, disc, w = plain_pigan
    x = torch.rand(2, 3, res, res, generator=torch.Generator().manual_seed(7))
    got = disc(x, res, alpha)
    want = ref_pigan.discriminator(w, x, res, alpha, 5)
    assert torch.allclose(got, want, atol=1e-5)


def test_pigan_iteration_matches_the_port(plain_pigan):
    from msra_practice_project_tpu_torch.train import common
    from msra_practice_project_tpu_torch.train.train_pigan import \
        make_gan_steps

    gen, disc, w = plain_pigan
    opts = [common.adam(m.parameters(), common.interp_lr(lr, end, 500),
                        betas=(0.0, 0.9))
            for m, lr, end in ((gen, 5e-5, 1e-5), (disc, 4e-4, 1e-4))]
    d_step, g_step = make_gan_steps(gen, disc, opts[0], opts[1], 8)
    stage = {"batch": 2, "resolution": 8, "fade_alpha": -1.0}
    trainer = ref_pigan.Trainer(w, PIGAN, stage, rays_per_block=64)
    g = torch.Generator().manual_seed(10)
    it = {"real": torch.rand(2, 3, 8, 8, generator=g)}
    for side in ("d_", "g_"):
        it[side + "z"] = torch.randn(2, PIGAN["z_dim"], generator=g)
        it[side + "theta"] = torch.randn(2, generator=g) * 0.45
        it[side + "phi"] = torch.randn(2, generator=g) * 0.15
        it[side + "jitter"] = torch.rand(2, 64, 8, generator=g)
    d = d_step(it["real"], it["d_z"], -1.0, poses=(it["d_theta"],
                                                   it["d_phi"]),
               jitter=it["d_jitter"])["d_loss"]
    gl = g_step(it["g_z"], -1.0, poses=(it["g_theta"], it["g_phi"]),
                jitter=it["g_jitter"])["g_loss"]
    want_d, want_g = trainer.iteration(it)
    assert float(d) == pytest.approx(float(want_d), rel=1e-5)
    assert float(gl) == pytest.approx(float(want_g), rel=1e-5)
    leaves = {**{"g." + k: p.detach() for k, p in gen.named_parameters()},
              **{"d." + k: p.detach() for k, p in disc.named_parameters()}}
    want = trainer.leaves()
    for net in ("g.", "d."):
        names = compare.moving_leaves({k: v for k, v in trainer.first.items()
                                       if k.startswith(net)})
        assert compare.leaf_gap(compare.change(leaves, w),
                                compare.change(want, w), names) < 1e-3

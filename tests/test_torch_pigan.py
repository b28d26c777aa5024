"""The port's pi-GAN models and DiffAugment
(msra_practice_project_tpu_torch.models.pigan, train.diff_augment) against
the JAX package on the CPU.  Weights reach the port through ``weights.py``;
the JAX package's random draws (poses, stratified jitter, augmentation) are
made with its keys and handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.models import pigan as jpigan
from msra_practice_project_tpu.train import diff_augment as jda
from msra_practice_project_tpu_torch.models import pigan
from msra_practice_project_tpu_torch.train import diff_augment as da
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


GEN_CFG = dict(z_dim=64, resolution=8, coarse_samples=5, fine_samples=4)


@pytest.fixture(scope="module")
def gen():
    """JAX generator params and the port's generator with the same weights."""
    jg = jpigan.Generator(jpigan.GeneratorConfig(**GEN_CFG))
    p = jg.init(jax.random.PRNGKey(0))
    g = pigan.Generator(pigan.GeneratorConfig(**GEN_CFG))
    g.load_state_dict(state_dict_from_params(_np_tree(p)))
    return jg, p, g


@pytest.fixture(scope="module")
def disc():
    jd = jpigan.Discriminator()
    p = jd.init(jax.random.PRNGKey(1))
    d = pigan.Discriminator()
    d.load_state_dict(state_dict_from_params(_np_tree(p)))
    return jd, p, d


def test_bridge_round_trips(gen, disc):
    """JAX tree -> state_dict -> JAX tree is exact; linear weights are
    transposed, conv weights (OIHW in both) are not."""
    for _, p, m in (gen, disc):
        back = params_from_state_dict(m.state_dict())
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(_np_tree(p))
        for a, b in zip(jax.tree_util.tree_leaves(_np_tree(p)),
                        jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(a, b)
    _, p, d = disc
    np.testing.assert_array_equal(d.blocks[0].conv1.weight.detach().numpy(),
                                  np.asarray(p["blocks"][0]["conv1"]["w"]))
    _, p, g = gen
    np.testing.assert_array_equal(g.mapping.trunk[0].weight.detach().numpy(),
                                  np.asarray(p["mapping"]["trunk"][0]["w"]).T)


def test_mapping_and_trunk_match_jax(gen):
    jg, p, g = gen
    rng = np.random.default_rng(0)
    z = rng.normal(size=(3, 64)).astype(np.float32)
    film_j = np.array(jg.get_mapping(p, jnp.asarray(z)))
    with torch.no_grad():
        film_t = g.get_mapping(torch.from_numpy(z))
    assert film_t.shape == (3, 9, 512)
    np.testing.assert_allclose(film_t.numpy(), film_j, atol=1e-5)
    # fresh heads are gamma = 1, beta = 0
    fresh = pigan.MappingNetwork(pigan.MappingConfig(input_dim=8))
    assert torch.equal(fresh.heads[3].bias[:256], torch.ones(256))
    assert torch.equal(fresh.heads[3].bias[256:], torch.zeros(256))
    x = (rng.normal(size=(3, 4, 5, 6)) * 0.3).astype(np.float32)
    ref = np.asarray(jg.trunk.apply(p["trunk"], jnp.asarray(x),
                                    jnp.asarray(film_j)))
    with torch.no_grad():
        out = g.trunk(torch.from_numpy(x), torch.from_numpy(film_j))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


def test_kernel_batched_guard():
    kb = pigan.FilmSirenNeRF._kernel_batched
    assert kb(torch.zeros(2, 3, 6), torch.zeros(2, 9, 512))
    assert kb(torch.zeros(2, 3, 4, 6), torch.zeros(2, 9, 512))
    assert not kb(torch.zeros(4, 6, 6), torch.zeros(9, 512))
    assert not kb(torch.zeros(3, 5, 6), torch.zeros(2, 9, 512))
    assert not kb(torch.zeros(6), torch.zeros(1, 9, 512))


def _jax_draws(jg, key, b):
    """The poses and stratified jitter Generator.apply draws from `key`."""
    k_pose, k_render = jax.random.split(key)
    theta, phi = jg.sample_poses(k_pose, b)
    res, nc = GEN_CFG["resolution"], GEN_CFG["coarse_samples"]
    jitter = jax.random.uniform(k_render, (b, res * res, nc), jnp.float32)
    return (torch.from_numpy(np.asarray(theta)),
            torch.from_numpy(np.asarray(phi)),
            torch.from_numpy(np.asarray(jitter)))


def test_render_film_and_apply_with_injected_poses_and_jitter(gen):
    """5 coarse samples make the linspace exact; the fine samples come out
    of sample_pdf's cumsum, which the two frameworks round in another
    order, so images agree to 1e-4."""
    jg, p, g = gen
    key = jax.random.PRNGKey(3)
    z = np.random.default_rng(1).normal(size=(2, 64)).astype(np.float32)
    ref = np.asarray(jg.apply(p, key, jnp.asarray(z)))
    theta, phi, jitter = _jax_draws(jg, key, 2)
    with torch.no_grad():
        imgs = g(torch.from_numpy(z), poses=(theta, phi), jitter=jitter)
        film = g.get_mapping(torch.from_numpy(z))
        hwc = g.render_film(film, theta, phi, jitter=jitter)
    assert imgs.shape == (2, 3, 8, 8) and hwc.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(imgs.numpy(), ref, atol=1e-4)
    np.testing.assert_array_equal(hwc.permute(0, 3, 1, 2).numpy(),
                                  imgs.numpy())
    # the poses: camera_poses matches the JAX package's per-pose matrices
    from msra_practice_project_tpu.ops import rays as jrays
    c2w = pigan.camera_poses(theta, phi)
    for i in range(2):
        np.testing.assert_allclose(
            c2w[i].numpy(), np.asarray(jrays.camera_pose(
                1.0, float(theta[i]), float(phi[i]))), atol=1e-6)


@pytest.mark.parametrize("res", [4, 8, 16, 32, 64])
def test_discriminator_matches_jax_at_every_resolution(disc, res):
    jd, p, d = disc
    x = np.random.default_rng(res).uniform(size=(2, 3, res, res)).astype(
        np.float32)
    for alpha in (-1.0, 0.5):
        ref = np.asarray(jd.apply(p, jnp.asarray(x), res, alpha))
        with torch.no_grad():
            out = d(torch.from_numpy(x), res, alpha)
        assert out.shape == (2,)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
    ref = np.asarray(jd.apply_features(p, jnp.asarray(x), res))
    with torch.no_grad():
        feats = d.apply_features(torch.from_numpy(x), res)
    np.testing.assert_allclose(feats.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_discriminator_refuses_resolutions_off_the_ladder(disc):
    _, _, d = disc
    with pytest.raises(ValueError, match="ladder"):
        d(torch.zeros(1, 3, 128, 128), 128)


def test_add_coords_and_avg_pool_match_jax():
    """The coordinate channels agree to an ulp (the two linspaces round in
    another order); the image channels are passed through."""
    x = np.random.default_rng(2).normal(size=(2, 3, 5, 7)).astype(np.float32)
    out = pigan.add_coords(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jpigan.add_coords(jnp.asarray(x))), atol=2e-7)
    np.testing.assert_array_equal(out[:, :3], x)
    y = np.random.default_rng(3).normal(size=(2, 3, 6, 8)).astype(np.float32)
    np.testing.assert_allclose(pigan.avg_pool2(torch.from_numpy(y)).numpy(),
                               np.asarray(jpigan.avg_pool2(jnp.asarray(y))),
                               atol=1e-6)


def _aug_case(name, key, x):
    """JAX's op on x with `key`, and the draws it made, for the port."""
    n, _, h, w = x.shape
    u = lambda k, lo, hi: jax.random.uniform(k, (n,), minval=lo, maxval=hi)
    if name in ("brightness", "saturation", "contrast"):
        lo, hi = {"brightness": (-0.5, 0.5), "saturation": (0.0, 2.0),
                  "contrast": (0.5, 1.5)}[name]
        draws = (u(key, lo, hi),)
    elif name == "color":
        k1, k2, k3 = jax.random.split(key, 3)
        draws = (u(k1, -0.5, 0.5), u(k2, 0.0, 2.0), u(k3, 0.5, 1.5))
    else:
        ratio = 0.125 if name == "translation" else 0.5
        sh, sw = max(int(h * ratio), 1), max(int(w * ratio), 1)
        k1, k2 = jax.random.split(key)
        if name == "translation":
            draws = (jax.random.randint(k1, (n,), -sh, sh + 1),
                     jax.random.randint(k2, (n,), -sw, sw + 1))
        else:
            draws = (jax.random.randint(k1, (n,), -(sh // 2),
                                        h - sh + sh // 2 + 1),
                     jax.random.randint(k2, (n,), -(sw // 2),
                                        w - sw + sw // 2 + 1))
    ref = np.asarray(jda._OPS[name](jnp.asarray(x), key))
    return ref, [torch.from_numpy(np.asarray(d)) for d in draws]


@pytest.mark.parametrize("name", ["brightness", "saturation", "contrast",
                                  "color", "translation", "cutout"])
def test_diff_augment_ops_match_jax_with_its_draws(name):
    x = np.random.default_rng(4).uniform(size=(4, 3, 16, 12)).astype(
        np.float32)
    ref, draws = _aug_case(name, jax.random.PRNGKey(5), x)
    xt = torch.from_numpy(x).requires_grad_()
    out = da._OPS[name](xt, *draws)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)
    out.sum().backward()        # differentiable
    assert xt.grad is not None
    # the generator's draws have the same support
    g = torch.Generator().manual_seed(0)
    for d, want in zip(da.draw(name, xt, g), draws):
        assert d.shape == want.shape
        assert d.is_floating_point() == want.is_floating_point()


def test_augment_applies_a_policy_and_refuses_unknown_ops():
    x = torch.rand(2, 3, 8, 8)
    g = torch.Generator().manual_seed(0)
    out = da.augment(x, "color,translation,cutout", g)
    assert out.shape == x.shape and not torch.equal(out, x)
    assert da.parse_policy(" color, cutout ") == ["color", "cutout"]
    with pytest.raises(ValueError, match="unknown"):
        da.parse_policy("color,flip")

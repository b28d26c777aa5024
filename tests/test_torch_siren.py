"""The port's SIREN models (msra_practice_project_tpu_torch.models.siren_mlp,
the SirenNeRF of models.nerf, core.nn.siren_init) and its SIREN configs
against the JAX package, on the CPU.  Weights reach the port through
``weights.py``; inputs are drawn with numpy from a seed.

Tolerances: the sine kinds at 2e-5 x max(1, max|ref|), the trunk tolerance
of tests/test_torch_pigan.py (w0 = 30 turns an ulp of a pre-activation into
30 ulps of its sine); the tanh/relu/relu_pe kinds at 1e-5 x max(1,
max|ref|); gradients in relative Frobenius norm per tensor."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.core import config as jconfig
from msra_practice_project_tpu.core import nn as jnn
from msra_practice_project_tpu.models import siren_mlp as jsiren
from msra_practice_project_tpu.models.nerf import nerf_model as jnerf_model
from msra_practice_project_tpu_torch.core import config
from msra_practice_project_tpu_torch.core import nn as tnn
from msra_practice_project_tpu_torch.models import siren_mlp
from msra_practice_project_tpu_torch.models.nerf import nerf_model
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


def _tol(kind, ref):
    scale = 2e-5 if kind == "siren" else 1e-5
    return scale * max(1.0, float(np.abs(ref).max()))


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _pair(factory, kind, seed=1):
    """(JAX model, its params, the port's model with the same weights)."""
    jm = getattr(jsiren, factory)(kind)
    p = jm.init(jax.random.PRNGKey(seed))
    tm = getattr(siren_mlp, factory)(kind)
    tm.load_state_dict(state_dict_from_params(_np_tree(p)))
    return jm, p, tm


# -- inits -----------------------------------------------------------------

SCHEMES = {  # scheme -> (weight bound, bias bound) at in 256
    "torch_default": (1 / 16, 1 / 16), "first": (1 / 256, 1 / 16),
    "hidden": (np.sqrt(6 / 256) / 30, 1 / 16),
    "nerf": (np.sqrt(6 / 256) / 30, 0.0), "nerf_first": (1 / 30, 0.0)}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_siren_init_schemes_match_jax(scheme):
    """Both packages draw U(+-w) weights and U(+-b) or zero biases with the
    same bounds (checked on 256 x 256 draws: every value inside, the
    largest within 2% of the bound); the port draws the weight first, then
    a nonzero bias, from its generator, and [out, in] is JAX's [in, out]
    transposed."""
    w_bound, b_bound = SCHEMES[scheme]
    jp = _np_tree(jnn.siren_init(jax.random.PRNGKey(0), 256, 128, scheme))
    layer = tnn.siren_init(256, 128, scheme,
                           torch.Generator().manual_seed(3))
    assert layer.weight.shape == (128, 256) and jp["w"].shape == (256, 128)
    for w in (jp["w"], layer.weight.detach().numpy()):
        assert np.abs(w).max() <= w_bound
        assert np.abs(w).max() > 0.98 * w_bound
    for b in (jp["b"], layer.bias.detach().numpy()):
        if b_bound == 0:
            assert not b.any()
        else:
            assert b_bound * 0.9 < np.abs(b).max() <= b_bound
    g = torch.Generator().manual_seed(3)
    w = torch.empty(128, 256).uniform_(-w_bound, w_bound, generator=g)
    torch.testing.assert_close(layer.weight.detach(), w, rtol=0, atol=0)
    if b_bound:
        b = torch.empty(128).uniform_(-b_bound, b_bound, generator=g)
        torch.testing.assert_close(layer.bias.detach(), b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="scheme"):
        tnn.siren_init(4, 4, "xavier")


def test_siren_apply_matches_jax(rng):
    """sin(30 (x W^T + b)) through the polynomial sine."""
    p = _np_tree(jnn.siren_init(jax.random.PRNGKey(2), 64, 32, "first"))
    layer = tnn.siren_init(64, 32, "first")
    layer.load_state_dict(state_dict_from_params(p))
    x = rng.uniform(-1, 1, size=(200, 64)).astype(np.float32)
    want = np.asarray(jnn.siren_apply(p, jnp.asarray(x)))
    got = tnn.siren_apply(layer, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol("siren", want))


# -- ImplicitMLP -----------------------------------------------------------

@pytest.mark.parametrize("factory", ["img_model", "sdf_model"])
@pytest.mark.parametrize("kind", siren_mlp.KINDS)
def test_implicit_mlp_forward_matches_jax(factory, kind, rng):
    """Full width (3 x 256) on 256 points in [-1, 1]^d."""
    jm, p, tm = _pair(factory, kind)
    d = jm.cfg.input_dim
    assert tm.cfg == siren_mlp.MLPConfig(d, 1, 256, 3, kind=kind)
    x = rng.uniform(-1, 1, size=(256, d)).astype(np.float32)
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (256, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(kind, want))


@pytest.mark.parametrize("kind", siren_mlp.KINDS)
def test_implicit_mlp_input_grad_matches_jax(kind, rng):
    """d sum f / dx of the SDF model against jax.grad: the eikonal and
    normal terms' input gradients (relu_pe's PE reaches frequency 2^9)."""
    jm, p, tm = _pair("sdf_model", kind)
    x = rng.uniform(-1, 1, size=(256, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jm.apply(p, v).sum())(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(tm(xt).sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_tol(kind, want))


def test_implicit_mlp_init_is_seeded_and_rejects_unknown_kinds():
    a, b = (siren_mlp.sdf_model("siren",
                                generator=torch.Generator().manual_seed(0))
            for _ in range(2))
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert not a.output.bias.any()          # the "nerf" output scheme
    assert a.input.weight.abs().max() <= 1 / 3
    with pytest.raises(ValueError, match="kind"):
        siren_mlp.img_model("gelu")


@pytest.mark.parametrize("kind", siren_mlp.KINDS)
def test_weight_bridge_round_trips_the_implicit_mlp(kind):
    """JAX tree -> state_dict -> JAX tree is exact, names and all."""
    _, p, tm = _pair("img_model", kind)
    assert set(tm.state_dict()) == {
        "input.weight", "input.bias", "output.weight", "output.bias",
        *(f"hidden.{i}.{k}" for i in range(3) for k in ("weight", "bias"))}
    back = params_from_state_dict(tm.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(_np_tree(p))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_np_tree(p))):
        np.testing.assert_array_equal(a, b)


# -- SirenNeRF -------------------------------------------------------------

@pytest.fixture(scope="module")
def siren_nerf():
    jm = jnerf_model(True)
    p = jm.init(jax.random.PRNGKey(5))
    tm = nerf_model(True)
    tm.load_state_dict(state_dict_from_params(_np_tree(p)))
    return jm, p, tm


def test_siren_nerf_layout(siren_nerf):
    """8 sine layers (the first nerf_first, the skip layer 259 in), the
    linear feature layer, the 259-in direction sine layer, relu sigma and
    sigmoid rgb; the PE model's layout is unchanged."""
    _, p, tm = siren_nerf
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert shapes["layers_pos.0.weight"] == (256, 3)
    assert shapes["layers_pos.5.weight"] == (256, 259)
    assert shapes["layers_dir.0.weight"] == (256, 256)
    assert shapes["layers_dir.1.weight"] == (128, 259)
    assert shapes["sigma.weight"] == (1, 256)
    assert shapes["rgb.weight"] == (3, 128)
    assert len(shapes) == len(jax.tree_util.tree_leaves(p))
    fresh = nerf_model(True, generator=torch.Generator().manual_seed(0))
    assert all(not fresh.layers_pos[i].bias.any() for i in range(8))
    assert fresh.layers_pos[0].weight.abs().max() <= 1 / 30
    pe = nerf_model(False).state_dict()
    assert pe["layers_pos.0.weight"].shape == (256, 60)
    assert pe["layers_dir.1.weight"].shape == (128, 280)


def test_weight_bridge_round_trips_the_siren_nerf(siren_nerf):
    """JAX tree -> state_dict -> JAX tree is exact for the SirenNeRF."""
    _, p, tm = siren_nerf
    back = params_from_state_dict(tm.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(_np_tree(p))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_np_tree(p))):
        np.testing.assert_array_equal(a, b)


def test_siren_nerf_forward_and_grads_match_jax(siren_nerf, rng):
    """Forward on 512 points (positions in [-1.5, 1.5]^3, unnormalised view
    directions) and the gradient of sum(out * c) with respect to every
    parameter; rgb/sigma at the sine tolerance, gradients at 1e-4 relative
    Frobenius norm per tensor."""
    jm, p, tm = siren_nerf
    x = np.concatenate([rng.uniform(-1.5, 1.5, size=(512, 3)),
                        rng.normal(size=(512, 3))], 1).astype(np.float32)
    c = rng.normal(size=(512, 4)).astype(np.float32)
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=_tol("siren", want))
    assert want[:, 3].max() > 0 and (want[:, :3] > 0).all()

    g_j = jax.grad(lambda q: (jm.apply(q, jnp.asarray(x))
                              * jnp.asarray(c)).sum())(p)
    (out * torch.from_numpy(c)).sum().backward()
    g_t = params_from_state_dict(
        {k: v.grad for k, v in tm.named_parameters()})
    for a, b in zip(jax.tree_util.tree_leaves(g_t),
                    jax.tree_util.tree_leaves(_np_tree(g_j))):
        assert a.shape == b.shape and _rel(a, b) < 1e-4
    tm.zero_grad()


# -- configs ---------------------------------------------------------------

SIREN_CONFIGS = sorted(glob.glob(os.path.join(config.CONFIG_ROOT, "siren",
                                              "*.json")))


def test_siren_default_tables_match_jax():
    assert config.SIREN_IMG_DEFAULTS == jconfig.SIREN_IMG_DEFAULTS
    assert config.SIREN_SDF_DEFAULTS == jconfig.SIREN_SDF_DEFAULTS
    assert len(SIREN_CONFIGS) == 13


@pytest.mark.parametrize("name", [os.path.basename(p) for p in SIREN_CONFIGS]
                         + ["lego_siren.json"])
def test_siren_configs_resolve_in_place(name):
    """Every SIREN config (and nerf/lego_siren.json) resolves in the port
    exactly as in the JAX package, and names a model the port builds."""
    sub = "nerf" if name == "lego_siren.json" else "siren"
    path = os.path.join(config.CONFIG_ROOT, sub, name)
    if sub == "nerf":
        tables = (config.NERF_TRAIN_DEFAULTS, jconfig.NERF_TRAIN_DEFAULTS)
    elif "_img" in name:
        tables = (config.SIREN_IMG_DEFAULTS, jconfig.SIREN_IMG_DEFAULTS)
    else:
        tables = (config.SIREN_SDF_DEFAULTS, jconfig.SIREN_SDF_DEFAULTS)
    got = config.resolve(config.load_config(path), tables[0])
    assert got == jconfig.resolve(jconfig.load_config(path), tables[1])
    if sub == "nerf":
        assert got["use_siren"] and got["learning_rate"] == 1e-4
    else:
        assert got["model_type"] in siren_mlp.KINDS
        assert got["batch_size"] == 65536

"""pi-GAN's plain trunk (mode 0, ``MSRA_TPU_FUSED_FILM=0``) under autograd
in the port: the memory-lean FiLM sine (``core.nn.FilmSine``) and the coarse
pass of ``Generator.render_film``, which records no graph.

``FilmSine`` keeps lin, gamma and beta for its backward, where autograd of
``trunk_sin(w0 * (gamma * lin + beta))`` keeps every step of the sine; its
forward is that expression bitwise.  The trunk is held against the JAX
package's ``FilmSirenNeRF._apply_xla`` under ``jax.grad``, with the weights
shared through ``weights.py``; what autograd saves is counted with
``torch.autograd.graph.saved_tensors_hooks``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.models import pigan as jpigan
from msra_practice_project_tpu_torch.core import nn as tnn
from msra_practice_project_tpu_torch.models import pigan
from msra_practice_project_tpu_torch.ops.render import render_rays
from msra_practice_project_tpu_torch.weights import state_dict_from_params

W0 = 30.0
X_SHAPE = (2, 5, 10, 6)          # [B, rays, samples, 6]: 100 points
N_PTS = math.prod(X_SHAPE[:-1])
# The mode-0 trunk's guard: point-sized bytes autograd saves per point, in
# fp32 256-wide tensors (~68.8 with the sine's steps recorded, ~19.3 lean).
MAX_SAVED_TENSORS = 20


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
def mode0(monkeypatch):
    monkeypatch.setenv("MSRA_TPU_FUSED_FILM", "0")


def _old_film_siren_apply(layer, x, gamma, beta, w0=W0):
    """film_siren_apply before FilmSine: the plain ops under autograd."""
    return tnn.trunk_sin(w0 * (gamma * layer(x) + beta))


def _film_operands(batched, seed, width=16):
    """lin [2, 3, 4, width] and gamma/beta as FilmSirenNeRF._gamma_beta
    aligns them: [2, 1, 1, width] for the batched film [B, n_film, 2h],
    [1, 1, 1, width] for the unbatched [n_film, 2h]."""
    rng = np.random.default_rng(seed)
    lin = torch.from_numpy(rng.normal(size=(2, 3, 4, width)).astype(
        np.float32))
    lead = 2 if batched else 1
    gamma = torch.from_numpy((1.0 + 0.1 * rng.normal(
        size=(lead, 1, 1, width))).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.normal(
        size=(lead, 1, 1, width))).astype(np.float32))
    dh = torch.from_numpy(rng.normal(size=lin.shape).astype(np.float32))
    return lin, gamma, beta, dh


def _trunk(use_dir=True):
    """JAX trunk params and the port's trunk with the same weights."""
    p = jpigan.FilmSirenNeRF(jpigan.FilmSirenNeRFConfig(
        use_dir=use_dir)).init(jax.random.PRNGKey(0))
    t = pigan.FilmSirenNeRF(pigan.FilmSirenNeRFConfig(use_dir=use_dir))
    t.load_state_dict(state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, p)))
    return p, t


def _trunk_inputs(seed):
    """x [2, 5, 10, 6], film [2, 9, 512] near (gamma=1, beta=0), dy."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=X_SHAPE) * 0.3).astype(np.float32)
    film = (rng.normal(size=(2, 9, 512)) * 0.1).astype(np.float32)
    film[..., :256] += 1.0
    dy = rng.normal(size=X_SHAPE[:-1] + (4,)).astype(np.float32)
    return x, film, dy


def _scaled_close(a, b, atol):
    scale = float(np.abs(b).max()) + 1e-8
    np.testing.assert_allclose(a / scale, b / scale, atol=atol)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("fast", [True, False])
def test_film_sine_forward_is_bitwise_the_plain_expression(
        monkeypatch, mode0, fast):
    """FilmSine, for batched and unbatched film, and the mode-0 trunk, with
    and without a graph, against the expression it replaces."""
    monkeypatch.setattr(tnn, "USE_FAST_SIN", fast)
    for batched in (True, False):
        lin, gamma, beta, _ = _film_operands(batched, 1)
        ref = tnn.trunk_sin(W0 * (gamma * lin + beta))
        assert torch.equal(tnn.FilmSine.apply(lin, gamma, beta, W0), ref)
        lin.requires_grad_()
        assert torch.equal(tnn.FilmSine.apply(lin, gamma, beta, W0), ref)

    _, t = _trunk()
    x, film, _ = _trunk_inputs(2)
    xt, ft = torch.from_numpy(x), torch.from_numpy(film).requires_grad_()
    got = t(xt, ft)
    with torch.no_grad():
        got_no_grad = t(xt, ft)
    with monkeypatch.context() as m:
        m.setattr(pigan, "film_siren_apply", _old_film_siren_apply)
        old = t(xt, ft)
    assert got.grad_fn is not None
    assert torch.equal(got, old) and torch.equal(got_no_grad, old)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("batched", [True, False])
def test_film_sine_grads_match_autograd_of_the_plain_ops(
        monkeypatch, fast, batched):
    """The gradients for lin, gamma and beta against autograd of the plain
    ops on the polynomial sine and on torch.sin (MSRA_TPU_FAST_SIN=0):
    fp32 roundoff apart, with gamma/beta summed over the axes they
    broadcast along."""
    monkeypatch.setattr(tnn, "USE_FAST_SIN", fast)
    lin, gamma, beta, dh = _film_operands(batched, 3)
    grads = []
    for fn in (lambda a, g, b: tnn.FilmSine.apply(a, g, b, W0),
               lambda a, g, b: tnn.trunk_sin(W0 * (g * a + b))):
        ins = [v.clone().requires_grad_() for v in (lin, gamma, beta)]
        grads.append(torch.autograd.grad((fn(*ins) * dh).sum(), ins))
    for a, b in zip(*grads):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b.numpy()) <= 1e-6
        _scaled_close(a.numpy(), b.numpy(), 1e-6)


def test_mode0_trunk_matches_jax_apply_xla(mode0):
    """The mode-0 trunk's forward (2e-5) and its gradients for every
    parameter, film and x (scaled 2e-4, as tests/test_torch_film_mlp.py
    holds the fused trunk) against jax.grad of the JAX package's plain
    trunk at the same weights."""
    p, t = _trunk()
    x, film, dy = _trunk_inputs(4)
    jt = jpigan.FilmSirenNeRF(jpigan.FilmSirenNeRFConfig())

    def loss(params, x, film):
        out = jt._apply_xla(params, x, film)
        return jnp.sum(out * dy), out

    (_, out_j), (gp_j, gx_j, gf_j) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(p, jnp.asarray(x),
                                               jnp.asarray(film))
    xt = torch.from_numpy(x).requires_grad_()
    ft = torch.from_numpy(film).requires_grad_()
    out = t(xt, ft)
    (out * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=2e-5)
    _scaled_close(xt.grad.numpy(), np.asarray(gx_j), 2e-4)
    _scaled_close(ft.grad.numpy(), np.asarray(gf_j), 2e-4)
    want = state_dict_from_params(jax.tree_util.tree_map(np.asarray, gp_j))
    got = dict(t.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        _scaled_close(got[name].grad.numpy(), g.numpy(), 2e-4)


def _saved(fn):
    """fn() under saved_tensors_hooks: the shapes and byte counts of every
    tensor autograd saves for the backward."""
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.numel() * t.element_size()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, saved


def test_mode0_trunk_saves_at_most_20_tensors_a_point(monkeypatch, mode0):
    """Every point-sized tensor autograd keeps for the mode-0 trunk's
    backward, counted where it is saved: at most 20 fp32 256-wide tensors a
    point; the plain ops that FilmSine replaced kept more than 60."""
    _, t = _trunk()
    x, film, _ = _trunk_inputs(5)
    xt = torch.from_numpy(x).requires_grad_()
    ft = torch.from_numpy(film).requires_grad_()

    def per_point(saved):
        nbytes = sum(b for shape, b in saved
                     if math.prod(shape[:-1]) == N_PTS)
        return nbytes / N_PTS / (256 * 4)

    _, lean = _saved(lambda: t(xt, ft))
    with monkeypatch.context() as m:
        m.setattr(pigan, "film_siren_apply", _old_film_siren_apply)
        _, old = _saved(lambda: t(xt, ft))
    assert per_point(lean) <= MAX_SAVED_TENSORS, per_point(lean)
    assert per_point(old) > 60, per_point(old)


def test_trunk_double_backward_raises(mode0):
    """No path differentiates the trunk twice (R1 differentiates D at the
    real images), so FilmSine is once differentiable: a second backward
    raises instead of returning a wrong value."""
    _, t = _trunk()
    x, film, _ = _trunk_inputs(6)
    xt = torch.from_numpy(x).requires_grad_()
    ft = torch.from_numpy(film).requires_grad_()
    (dfilm,) = torch.autograd.grad(t(xt, ft).sum(), ft, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dfilm.sum().backward()


def _render_case():
    """A small generator, film codes, poses and jitter: B 2 at 8x8 with 5
    coarse + 6 fine samples (640 coarse points, 1,408 fine)."""
    torch.manual_seed(0)
    cfg = pigan.GeneratorConfig(z_dim=32, resolution=8, coarse_samples=5,
                                fine_samples=6)
    g = pigan.Generator(cfg, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(7)
    z = torch.from_numpy(rng.normal(size=(2, 32)).astype(np.float32))
    theta = torch.from_numpy((0.3 * rng.normal(size=2)).astype(np.float32))
    phi = torch.from_numpy((0.1 * rng.normal(size=2)).astype(np.float32))
    jitter = torch.from_numpy(rng.uniform(size=(2, 64, 5)).astype(
        np.float32))
    return g, z, theta, phi, jitter


def _coarse_sized(saved, n_img=2, rays=64, nc=5):
    """Saved tensors laid out over the coarse pass's points."""
    return [s for s, _ in saved
            if math.prod(s[:-1]) == n_img * rays * nc
            or tuple(s[1:3]) == (rays, nc)]


def test_render_film_coarse_pass_records_no_graph(monkeypatch, mode0):
    """render_film against the same render with the coarse pass recorded
    (the trunk as both coarse_fn and fine_fn): the image and every
    gradient of G bitwise, and no saved tensor laid out over the coarse
    pass's points, where the recorded coarse pass saves some."""
    g, z, theta, phi, jitter = _render_case()
    params = list(g.parameters())

    def run():
        img, saved = _saved(lambda: g.render_film(
            g.get_mapping(z), theta, phi, jitter=jitter))
        grads = torch.autograd.grad(img.square().sum(), params,
                                    allow_unused=True)
        return img.detach(), grads, saved

    img, grads, saved = run()

    def recorded(o, d, near, far, coarse_fn, fine_fn, *a, **k):
        return render_rays(o, d, near, far, fine_fn, fine_fn, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(pigan, "render_rays", recorded)
        img_r, grads_r, saved_r = run()
    assert torch.equal(img, img_r)
    for a, b in zip(grads, grads_r):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    assert _coarse_sized(saved) == []
    assert _coarse_sized(saved_r)
    assert _coarse_sized(saved, nc=11)

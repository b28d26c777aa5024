"""The exact trunk sine (``MSRA_TPU_FAST_SIN=0``) of the port against the
JAX package's, on the CPU.

With the switch at 0 both packages take the exact sine in the SIREN and
FiLM trunks (``jnp.sin`` / ``torch.sin``) and in the FiLM kernels: the
Pallas kernels (run here in interpret mode, as the JAX package's own tests
run them) and the port's plain versions of K7 and K8.  Each test flips both
flags together (the ``exact`` fixture).  The JAX package reads its flag when
it traces, and its ``_fused_forward``/``_fused_backward`` are module-level
jits, so the fixture clears JAX's caches after the flip and again after the
restore.

The CUDA kernels' exact-sine instantiations run only on a card:
``python3 chip_smoke.py`` holds them against these plain versions there."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.core import nn as jnn
from msra_practice_project_tpu.models import pigan as jpigan
from msra_practice_project_tpu.models import siren_mlp as jsiren
from msra_practice_project_tpu.ops.pallas import film_mlp as JK
from msra_practice_project_tpu.train import common as jcommon
from msra_practice_project_tpu.train import train_img as jtrain_img
from msra_practice_project_tpu.train import train_pigan as jtrain
from msra_practice_project_tpu.train import train_sdf as jtrain_sdf
from msra_practice_project_tpu_torch.core import nn as tnn
from msra_practice_project_tpu_torch.data import image as image_data
from msra_practice_project_tpu_torch.data.pointcloud import (
    make_synthetic_sphere_cloud)
from msra_practice_project_tpu_torch.models import pigan, siren_mlp
from msra_practice_project_tpu_torch.ops.kernels import film_mlp as K
from msra_practice_project_tpu_torch.train import (common, train_img,
                                                   train_pigan, train_sdf)
from msra_practice_project_tpu_torch.weights import (
    params_from_state_dict, state_dict_from_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def exact(monkeypatch):
    """Both packages on the exact sine for one test; JAX's traces cleared
    after the flip and after the restore."""
    monkeypatch.setattr(jnn, "USE_FAST_SIN", False)
    monkeypatch.setattr(tnn, "USE_FAST_SIN", False)
    jax.clear_caches()
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _scaled_close(a, b, atol):
    scale = float(np.abs(b).max()) + 1e-8
    np.testing.assert_allclose(a / scale, b / scale, atol=atol)


def _sine_grid():
    """test_torch_film_mlp.py's grid: [-40, 40] with the exact multiples and
    half multiples of pi and 2 pi."""
    k = np.arange(-12, 13)
    return np.concatenate([np.linspace(-40, 40, 4001), k * np.pi,
                           k * 2 * np.pi, (k + 0.5) * 2 * np.pi,
                           (k + 0.5) * np.pi]).astype(np.float32)


# -- the switch and the trunk sine --------------------------------------------

def test_default_trunk_sine_is_the_polynomial():
    """With MSRA_TPU_FAST_SIN unset the trunk sine, its derivative and the
    plain K8 are the polynomial's, bitwise; fast_sin=False differs."""
    assert tnn.USE_FAST_SIN and jnn.USE_FAST_SIN
    v = torch.from_numpy(_sine_grid())
    assert torch.equal(tnn.trunk_sin(v), tnn.fast_sin(v))
    assert torch.equal(tnn.trunk_sin_vjp(v), tnn.trunk_sin_vjp(v, True))
    assert not torch.equal(tnn.trunk_sin(v), torch.sin(v))
    assert torch.equal(tnn.trunk_sin(v, False), torch.sin(v))
    assert torch.equal(tnn.trunk_sin_vjp(v, False), torch.cos(v))
    _, t = _trunk(True)
    x_pad, f, w = _padded(t, *_inputs(1, 64, 0), True, False)
    assert torch.equal(K.film_mlp_fwd(x_pad, f, w, False),
                       K.film_mlp_fwd(x_pad, f, w, False, fast_sin=True))
    assert not torch.equal(K.film_mlp_fwd(x_pad, f, w, False),
                           K.film_mlp_fwd(x_pad, f, w, False, fast_sin=False))


@pytest.mark.parametrize("value", ["0", "1", None])
def test_switch_is_read_from_the_environment_at_import(value):
    """MSRA_TPU_FAST_SIN=0 makes USE_FAST_SIN False in a fresh process, as
    the JAX package reads it; 1 or unset leave the polynomial."""
    env = {k: v for k, v in os.environ.items() if k != "MSRA_TPU_FAST_SIN"}
    if value is not None:
        env["MSRA_TPU_FAST_SIN"] = value
    out = subprocess.run(
        [sys.executable, "-c", "from msra_practice_project_tpu_torch.core "
         "import nn; print(nn.USE_FAST_SIN)"], cwd=ROOT, env=env,
        capture_output=True, text=True, check=True, timeout=120).stdout
    assert out.strip() == str(value != "0")


@pytest.mark.parametrize("name", ["trunk_sin", "trunk_sin_vjp"])
def test_exact_trunk_sine_matches_jax(exact, name):
    """sin and its derivative cos, elementwise against JAX at 1e-6; autograd
    of the exact trunk_sin is trunk_sin_vjp."""
    v = _sine_grid()
    got = getattr(tnn, name)(torch.from_numpy(v)).numpy()
    want = np.asarray(getattr(jnn, name)(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, (np.cos if name.endswith("vjp")
                                     else np.sin)(v.astype(np.float64)),
                               atol=1e-6)
    vt = torch.from_numpy(v).requires_grad_()
    tnn.trunk_sin(vt).sum().backward()
    np.testing.assert_array_equal(vt.grad.numpy(),
                                  tnn.trunk_sin_vjp(vt.detach()).numpy())


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("vjp", [False, True])
def test_sin_eval_on_cpu_is_the_trunk_sine(fast, vjp):
    """sin_eval (the kernels' sine probe) takes trunk_sin/trunk_sin_vjp on
    CPU tensors and counts no launch."""
    v = torch.from_numpy(_sine_grid())
    before = K.sin_eval.launches
    want = (tnn.trunk_sin_vjp if vjp else tnn.trunk_sin)(v, fast)
    assert torch.equal(K.sin_eval(v, fast, vjp), want)
    assert K.sin_eval.launches == before


# -- K8 and K7: the plain versions against the Pallas kernels -----------------

def _trunk(use_dir):
    """JAX trunk params and the port's trunk with the same weights."""
    cfg = jpigan.FilmSirenNeRFConfig(use_dir=use_dir)
    p = jpigan.FilmSirenNeRF(cfg).init(jax.random.PRNGKey(0))
    t = pigan.FilmSirenNeRF(pigan.FilmSirenNeRFConfig(use_dir=use_dir))
    t.load_state_dict(state_dict_from_params(_np_tree(p)))
    return p, t


def _inputs(b, p, seed):
    """x [b, p, 6] and film near (gamma=1, beta=0), from numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, p, 6)) * 0.3).astype(np.float32)
    film = (rng.normal(size=(b, 9, 512)) * 0.1).astype(np.float32)
    film[..., :256] += 1.0
    return x, film


def _padded(t, x, film, use_dir, bf16):
    """The kernels' inputs: x [b, P_pad, 8], film and the kernel weights."""
    packed = K.pack_film_params(dict(t.named_parameters()), use_dir)
    w = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS], bf16)
    x_pad, _ = K.pad_points(torch.from_numpy(x), x.shape[0])
    return x_pad, torch.from_numpy(film), w


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_fwd_matches_jax_exact_kernel(exact, bf16):
    """The plain K8 against JAX's fused forward in interpret mode, both on
    the exact sine: fp32 at 2e-5, bf16 at 2e-2 relative Frobenius norm; the
    polynomial's output differs."""
    p, t = _trunk(True)
    x, film = _inputs(3, 35, 1)
    want = np.asarray(JK.fused_film_apply(p, jnp.asarray(x),
                                          jnp.asarray(film), True, bf16,
                                          True))
    x_pad, f, w = _padded(t, x, film, True, bf16)
    out = K.film_mlp_fwd(x_pad, f, w, bf16)
    got = out[:, :35, :4].numpy()
    if bf16:
        assert _rel(got, want) <= 2e-2
    else:
        np.testing.assert_allclose(got, want, atol=2e-5)
        with torch.no_grad():
            plain = t._apply_plain(torch.from_numpy(x), f).numpy()
        np.testing.assert_allclose(plain, want, atol=2e-5)
    poly = K.film_mlp_fwd(x_pad, f, w, bf16, fast_sin=True)
    assert float((poly - out).abs().max()) > 1e-7


def _jax_bwd(p, x, film, dy, bf16, need_dx):
    weights, x_pad, n = JK._prep(p, jnp.asarray(x), jnp.asarray(film), True)
    b, p_pad = x_pad.shape[:2]
    dy_pad = jnp.zeros((b, p_pad, 8), jnp.float32).at[:, :n, :4].set(
        jnp.asarray(dy))
    dx, dfilm, dw = JK._fused_backward(x_pad, jnp.asarray(film), dy_pad,
                                       weights, bf16, True, need_dx)
    return ([np.asarray(a) for a in dw] + [np.asarray(dfilm)]
            + ([np.asarray(dx)[:, :n]] if need_dx else []))


def _port_bwd(t, x, film, dy, bf16, need_dx, fast_sin=None):
    x_pad, f, w = _padded(t, x, film, True, bf16)
    n = x.shape[1]
    dy_pad = torch.zeros(x_pad.shape[0], x_pad.shape[1], 8)
    dy_pad[:, :n, :4] = torch.from_numpy(dy)
    dx, dfilm, dw = K.film_mlp_bwd(x_pad, f, dy_pad, w, bf16, need_dx,
                                   fast_sin)
    assert (dx is None) == (not need_dx)
    return ([a.numpy() for a in dw] + [dfilm.numpy()]
            + ([dx[:, :n].numpy()] if need_dx else []))


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_bwd_matches_jax_exact_kernel(exact, bf16, need_dx):
    """The plain K7's param, film and x grads against the Pallas backward in
    interpret mode, both on the exact sine and its cosine: fp32 at a scaled
    2e-4, bf16 at 2e-2 relative Frobenius norm (test_torch_film_mlp.py's
    gates); the polynomial's gradients differ."""
    p, t = _trunk(True)
    x, film = _inputs(2, 100, 2)
    dy = np.random.default_rng(3).normal(size=(2, 100, 4)).astype(np.float32)
    want = _jax_bwd(p, x, film, dy, bf16, need_dx)
    got = _port_bwd(t, x, film, dy, bf16, need_dx)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if bf16:
            assert _rel(a, b) <= 2e-2
        else:
            _scaled_close(a, b, 2e-4)
    poly = _port_bwd(t, x, film, dy, bf16, need_dx, fast_sin=True)
    assert _rel(poly[len(K.PACK_KEYS)], got[len(K.PACK_KEYS)]) > 1e-6


def _run(fn, x, film, dy, params):
    """fn(x, film) with x [2, 5, 10, 6]: (out, dx, dfilm, param grads)."""
    xt = torch.from_numpy(x).reshape(2, 5, 10, 6).requires_grad_()
    ft = torch.from_numpy(film).requires_grad_()
    for q in params:
        q.grad = None
    out = fn(xt, ft)
    (out * dy).sum().backward()
    return [out.detach(), xt.grad, ft.grad] + [q.grad for q in params]


def test_fused_function_on_the_exact_sine_matches_autograd(exact):
    """fused_film_apply (K8's and K7's plain versions, fp32) against
    autograd of the plain trunk, both on the exact sine: the forward at
    2e-5, every gradient at a scaled 2e-4."""
    _, t = _trunk(True)
    params = list(t.parameters())
    x, film = _inputs(2, 50, 8)
    dy = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 5, 10, 4)).astype(np.float32))
    ref = _run(t._apply_plain, x, film, dy, params)
    got = _run(lambda x, f: K.fused_film_apply(
        dict(t.named_parameters()), x, f, True, bf16=False), x, film, dy,
        params)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=2e-5)
    for a, b in zip(got[1:], ref[1:]):
        _scaled_close(a.numpy(), b.numpy(), 2e-4)


@pytest.mark.parametrize("forward_fast", [False, True])
def test_backward_takes_the_forward_sine(monkeypatch, forward_fast):
    """The sine is read when FilmTrunkFunction runs forward and recorded:
    flipping the switch before backward changes nothing, so the gradients
    equal those of a graph run wholly on the forward's sine."""
    _, t = _trunk(True)
    params = list(t.parameters())
    x, film = _inputs(2, 50, 10)
    dy = torch.from_numpy(np.random.default_rng(11).normal(
        size=(2, 5, 10, 4)).astype(np.float32))

    def apply(x, f):
        return K.fused_film_apply(dict(t.named_parameters()), x, f, True)

    monkeypatch.setattr(tnn, "USE_FAST_SIN", forward_fast)
    want = _run(apply, x, film, dy, params)

    def flipped(x, f):
        out = apply(x, f)
        tnn.USE_FAST_SIN = not forward_fast
        return out

    got = _run(flipped, x, film, dy, params)
    assert tnn.USE_FAST_SIN is (not forward_fast)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    other = _run(apply, x, film, dy, params)
    assert not torch.equal(other[2], want[2])


def test_exact_launch_counters_reset_and_cpu_calls_count_nothing(exact):
    K.reset_launch_counts()
    assert K.film_mlp_fwd.launches_exact == K.film_mlp_bwd.launches_exact == 0
    _, t = _trunk(True)
    x, film = _inputs(1, 64, 12)
    x_pad, f, w = _padded(t, x, film, True, True)
    K.film_mlp_fwd(x_pad, f, w, True)
    K.film_mlp_bwd(x_pad, f, torch.zeros(1, 64, 8), w, True, False)
    assert K.film_mlp_fwd.launches == K.film_mlp_fwd.launches_exact == 0
    assert K.film_mlp_bwd.launches == K.film_mlp_bwd.launches_exact == 0
    K.film_mlp_fwd.launches_exact = K.film_mlp_bwd.launches_exact = 2
    K.reset_launch_counts()
    assert K.film_mlp_fwd.launches_exact == K.film_mlp_bwd.launches_exact == 0


def test_cuda_source_instantiates_the_sine_policy_at_compile_time(
        monkeypatch):
    """Each of the four FiLM kernels that takes a sine is a template on
    EXACT, every epilogue calls trunk_sin<EXACT>/trunk_sin_vjp<EXACT>, and
    the C entry points take as many arguments, the exact flag among them,
    as the wrappers declare (read from a stub library: nothing is built)."""
    with open(os.path.join(ROOT, "msra_practice_project_tpu_torch", "ops",
                           "kernels", "csrc", "film_mlp.cu")) as f:
        src = f.read()
    for kernel, params in (("film_fwd_tc_kernel", "bool EXACT"),
                           ("film_fwd_tf32_kernel", "bool EXACT"),
                           ("film_bwd_delta_tc_kernel", "bool EXACT"),
                           ("film_bwd_delta_kernel",
                            "typename T, int TM, bool EXACT")):
        assert re.search(rf"template <{params}>\n__global__ void "
                         rf"__launch_bounds__\([A-Z_]+, 1\)\n{kernel}\(",
                         src), kernel
    calls = re.findall(r"trunk_sin(?:_vjp)?(<\w+>)?\(__fmul_rn", src)
    assert len(calls) == 5 and set(calls) == {"<EXACT>"}  # 5 epilogues

    class Fn:
        pass

    stub = type("Lib", (), {n: Fn() for n in (
        "film_mlp_fwd", "film_mlp_bwd", "film_sin_eval")})()
    from msra_practice_project_tpu_torch.ops.kernels import build
    monkeypatch.setattr(build, "load", lambda name: stub)
    assert K._lib() is stub
    for entry in ("film_mlp_fwd", "film_mlp_bwd", "film_sin_eval"):
        sig = src.split(f'extern "C" int {entry}(')[1].split(")")[0]
        assert sig.count(",") + 1 == len(getattr(stub, entry).argtypes)
        assert ("int exact" in sig) == (entry != "film_sin_eval")


# -- the slice as a whole: a pi-GAN G step, a SIREN image step, the SDF loss --

GEN_CFG = dict(z_dim=32, resolution=8, coarse_samples=5, fine_samples=4)
RES, BATCH, ALPHA = 8, 2, 0.5


class _NoUpdate:
    def step(self):
        pass


def _grads_close(module, grads_j, gate):
    got = params_from_state_dict({n: p.grad for n, p in
                                  module.named_parameters()})
    flat_t = jax.tree_util.tree_leaves_with_path(got)
    flat_j = jax.tree_util.tree_leaves(_np_tree(grads_j))
    assert len(flat_t) == len(flat_j)
    for (path, a), b in zip(flat_t, flat_j):
        assert _rel(a, b) <= gate, (jax.tree_util.keystr(path), _rel(a, b))


@pytest.mark.parametrize("mode,gate", [(0, 5e-3), (1, 5e-2)])
def test_pigan_g_step_on_the_exact_sine_matches_jax(exact, monkeypatch, mode,
                                                    gate):
    """One G step (the full-width trunk, a batch of 2 at 8x8) against JAX's
    with the same weights, latents and draws, both on the exact sine:
    g_loss at 1e-5 relative, G's gradients in relative Frobenius norm, mode
    0 (plain autograd, torch.sin) at 5e-3 and mode 1 (K8's and K7's plain
    versions, K7 in bf16) at 5e-2, test_torch_train_pigan.py's gates."""
    monkeypatch.setenv("MSRA_TPU_FUSED_FILM", str(mode))
    jg = jpigan.Generator(jpigan.GeneratorConfig(**GEN_CFG))
    jd = jpigan.Discriminator()
    gp, dp = jg.init(jax.random.PRNGKey(0)), jd.init(jax.random.PRNGKey(1))
    g = pigan.Generator(pigan.GeneratorConfig(**GEN_CFG))
    d = pigan.Discriminator()
    g.load_state_dict(state_dict_from_params(_np_tree(gp)))
    d.load_state_dict(state_dict_from_params(_np_tree(dp)))
    z = np.random.default_rng(1).normal(
        size=(BATCH, GEN_CFG["z_dim"])).astype(np.float32)
    key = jax.random.PRNGKey(6)

    def loss_fn(gp):
        fake = jg.apply(gp, key, jnp.asarray(z), RES)
        return jnp.mean(jtrain.loss_f(jd.apply(dp, fake, RES, ALPHA)))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(gp)
    k_pose, k_render = jax.random.split(key)
    theta, phi = jg.sample_poses(k_pose, BATCH)
    jitter = jax.random.uniform(
        k_render, (BATCH, RES * RES, GEN_CFG["coarse_samples"]), jnp.float32)
    _, g_step = train_pigan.make_gan_steps(g, d, _NoUpdate(), _NoUpdate(),
                                           RES)
    m_t = g_step(torch.from_numpy(z), ALPHA,
                 poses=(torch.from_numpy(np.array(theta)),
                        torch.from_numpy(np.array(phi))),
                 jitter=torch.from_numpy(np.array(jitter)))
    np.testing.assert_allclose(float(m_t["g_loss"]), float(loss_j),
                               rtol=1e-5)
    _grads_close(g, grads_j, gate)


def _siren_pair(factory, seed):
    jm = getattr(jsiren, factory)("siren")
    p = jm.init(jax.random.PRNGKey(seed))
    tm = getattr(siren_mlp, factory)("siren")
    tm.load_state_dict(state_dict_from_params(_np_tree(p)))
    return jm, p, tm


def _torch_grads(model):
    return jax.tree_util.tree_leaves(params_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()}))


def test_siren_image_step_on_the_exact_sine_matches_jax(exact):
    """One train_img step (siren kind, batch 64 of a 16 x 16 synthetic
    image) against JAX _train_step, both on the exact sine: the loss at
    1e-5 relative, the gradients at 1e-5 relative Frobenius norm."""
    buf = image_data.image_to_coords(image_data.make_synthetic_image(16))
    jm, p, tm = _siren_pair("img_model", 5)
    tx = jcommon.adam(1e-4)
    state, m = jtrain_img._train_step(
        jcommon.init_state(p, tx), jnp.asarray(buf), 0,
        apply_fn=jax.tree_util.Partial(jm.apply), tx=tx, batch_size=64)
    g_j = jax.tree_util.tree_map(           # Adam's mu = (1 - b1) g
        lambda mu: np.asarray(mu) / 0.1, state["opt_state"][0].mu)
    step = train_img.make_train_step(
        tm, common.adam(list(tm.parameters()), 1e-4))
    m_t = step(torch.from_numpy(buf[:64]))
    np.testing.assert_allclose(float(m_t["loss"]), float(m["loss"]),
                               rtol=1e-5)
    for a, b in zip(_torch_grads(tm), jax.tree_util.tree_leaves(
            _np_tree(g_j))):
        assert _rel(a, b) < 1e-5, (a.shape, _rel(a, b))


def test_sdf_loss_grad_in_grad_on_the_exact_sine_matches_jax(exact):
    """The SDF loss (siren kind) and its parameter gradients through the
    input gradients against JAX sdf_loss, both on the exact sine (torch.sin
    is differentiable twice): the loss at 1e-5 relative, every gradient at
    1e-4 relative Frobenius norm."""
    jm, p, tm = _siren_pair("sdf_model", 2)
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
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    for a, b in zip(_torch_grads(tm), jax.tree_util.tree_leaves(
            _np_tree(g_j))):
        assert _rel(a, b) < 1e-4, (a.shape, _rel(a, b))

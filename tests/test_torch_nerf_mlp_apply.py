"""The port's ``fused_nerf_apply`` at every flag combination, and its new
kernels' plain versions (K3/K6 forward, K5 recompute backward, K4 input
gradient), against the JAX package on the CPU; and the port of
``tools/roofline_nerf.py`` on the CPU.

The JAX Pallas kernels run in interpret mode, as their own tests run them;
weights reach the port through ``weights.py``.  The CUDA kernels run only on
a card: ``python3 chip_smoke.py`` holds them against these plain versions
there."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.models.nerf import nerf_model as jnerf_model
from msra_practice_project_tpu.ops import render as jrender
from msra_practice_project_tpu.ops.pallas import nerf_mlp as JK
from msra_practice_project_tpu_torch.models.nerf import nerf_model
from msra_practice_project_tpu_torch.ops import render
from msra_practice_project_tpu_torch.ops.kernels import nerf_mlp as K
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


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def shared():
    """JAX params with non-zero biases, and the port's model with the same
    weights."""
    p = jnerf_model(False).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    p = jax.tree_util.tree_map(
        lambda a: (jnp.asarray(rng.uniform(-0.1, 0.1, a.shape), jnp.float32)
                   if a.ndim == 1 else a), p)
    m = nerf_model()
    m.load_state_dict(state_dict_from_params(_np_tree(p)))
    return p, m


def _points(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, ref, bf16):
    """fp32: within 1e-4 of max|ref| elementwise; bf16: 5e-2 relative
    Frobenius (relu masks flip on bf16-rounded activations)."""
    if bf16:
        rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
        assert rel <= 5e-2, rel
    else:
        scale = float(np.abs(ref).max()) + 1e-8
        np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4)


@pytest.mark.parametrize("shape", [(300, 6), (4, 9, 6)])
@pytest.mark.parametrize("bf16", [False, True])
def test_forward_matches_jax_k3(shared, shape, bf16):
    """The primal (K3's plain version under no_grad) against JAX's
    fused_nerf_apply, leading dims kept."""
    p, m = shared
    x = _points(shape, 2)
    ref = np.asarray(JK.fused_nerf_apply(p, jnp.asarray(x), bf16, True))
    with torch.no_grad():
        out = K.fused_nerf_apply(m, torch.from_numpy(x), bf16).numpy()
    assert out.shape == shape[:-1] + (4,)
    np.testing.assert_allclose(out, ref, atol=5e-3 if bf16 else 2e-5)


def _jax_vjp(p, x, dy, bf16, need_dx, save_acts):
    _, vjp = jax.vjp(
        lambda p, x: JK.fused_nerf_apply(p, x, bf16, True, need_dx,
                                         save_acts), p, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    return _np_tree(gp), np.asarray(gx)


def _port_vjp(m, x, dy, bf16, need_dx, save_acts):
    m.zero_grad()
    xt = torch.from_numpy(x).requires_grad_()
    out = K.fused_nerf_apply(m, xt, bf16, need_dx, save_acts)
    (out * torch.from_numpy(dy)).sum().backward()
    g = {k: t.grad.clone() for k, t in m.named_parameters()}
    return params_from_state_dict(g), xt.grad.numpy()


@pytest.mark.parametrize("save_acts", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_param_and_input_grads_match_jax(shared, bf16, save_acts):
    """Parameter gradients and dx with need_dx: K5 + K4 at the defaults,
    K2 + K4 with save_acts, against the JAX kernels (interpret mode)."""
    p, m = shared
    x = _points((300, 6), 3)
    dy = _points((300, 4), 4)
    gp_j, gx_j = _jax_vjp(p, x, dy, bf16, True, save_acts)
    gp_t, gx_t = _port_vjp(m, x, dy, bf16, True, save_acts)
    for a, b in zip(jax.tree_util.tree_leaves(gp_j),
                    jax.tree_util.tree_leaves(gp_t)):
        _close(b, a, bf16)
    assert float(np.abs(gx_j).max()) > 0
    _close(gx_t, gx_j, bf16)


@pytest.mark.parametrize("save_acts", [False, True])
def test_need_dx_false_keeps_param_grads_and_zeros_dx(shared, save_acts):
    _, m = shared
    x = _points((200, 6), 5)
    dy = _points((200, 4), 6)
    g_dx, gx_dx = _port_vjp(m, x, dy, False, True, save_acts)
    g_no, gx_no = _port_vjp(m, x, dy, False, False, save_acts)
    for a, b in zip(jax.tree_util.tree_leaves(g_dx),
                    jax.tree_util.tree_leaves(g_no)):
        np.testing.assert_array_equal(a, b)
    assert float(np.abs(gx_dx).max()) > 0
    assert float(np.abs(gx_no).max()) == 0.0 and gx_no.shape == x.shape


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_forward_matches_jax_pipelined_kernel(shared, bf16):
    """The plain version of K3 and K6 against JAX's pipelined forward (K6)
    on 96 points in tiles of 32, which its own test holds bitwise equal to
    K3."""
    p, m = shared
    x = np.random.default_rng(7).uniform(-1, 1, (96, 6)).astype(np.float32)
    w, xp, n, _ = JK._prep(p, jnp.asarray(x), bf16)
    ref = np.asarray(JK._fused_forward(xp, w, bf16=bf16, interpret=True,
                                       tile=32, pipe=True))[:n]
    packed = K.pack_nerf_params(m)
    wk = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS], bf16)
    out = K.nerf_mlp_fwd_pipelined(K.pad_points(torch.from_numpy(x)), wk,
                                   bf16)[:n].numpy()
    np.testing.assert_allclose(out, ref, atol=5e-3 if bf16 else 2e-5)


def test_k5_plain_equals_k1_then_k2_and_k4_reads_either(shared):
    """The plain K5 (recompute) gives K1 -> K2's gradients and deltas, and
    the plain K4 gives one dx from either route's deltas."""
    _, m = shared
    x = K.pad_points(torch.from_numpy(_points((150, 6), 8)))
    dy = torch.from_numpy(_points((x.shape[0], K.OUT_PAD), 9))
    packed = K.pack_nerf_params(m)
    for bf16 in (False, True):
        wk = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS],
                              bf16)
        _, acts = K.nerf_mlp_fwd_save(x, wk, bf16)
        g2, dh2 = K.nerf_mlp_bwd_saved(wk, dy, acts, bf16)
        g5, dh5 = K.nerf_mlp_bwd(x, wk, dy, bf16, True)
        assert K.nerf_mlp_bwd(x, wk, dy, bf16, False)[1] is None
        for a, b in zip(g2, g5):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7)
        for a, b in zip(dh2, dh5):
            assert a.dtype == (torch.bfloat16 if bf16 else torch.float32)
            np.testing.assert_array_equal(a.float().numpy(),
                                          b.float().numpy())
        np.testing.assert_array_equal(K.nerf_mlp_dx(x, wk, dh2, bf16).numpy(),
                                      K.nerf_mlp_dx(x, wk, dh5, bf16).numpy())


def test_fused_inside_render_rays_matches_jax(shared):
    """The default-flag fused MLP inside render_rays under autograd, on JAX's
    test_fused_inside_render_and_jit setup (32 rays, 8 + 16 samples, fp32):
    the loss and the parameter gradients (the fine samples come out of
    sample_pdf's cumsum, which JAX rounds in another order, so gradients are
    held in relative norm)."""
    p, m = shared
    rays_o = np.broadcast_to(np.float32([0.0, 0.0, 4.0]), (32, 3)).copy()
    rays_d = np.broadcast_to(np.float32([0.0, 0.0, -1.0]), (32, 3)).copy()
    key = jax.random.PRNGKey(0)

    def jloss(p):
        f = jax.tree_util.Partial(
            lambda pp, x: JK.fused_nerf_apply(pp, x, False, True), p)
        out = jrender.render_rays(key, jnp.asarray(rays_o),
                                  jnp.asarray(rays_d), 2.0, 6.0, f, f, 8, 16)
        return (out["rgb_fine"] ** 2).sum()

    loss_j, g_j = jax.value_and_grad(jloss)(p)
    jitter = torch.from_numpy(np.array(jax.random.uniform(key, (32, 8))))
    m.zero_grad()

    def f(x):
        return K.fused_nerf_apply(m, x, False)

    out = render.render_rays(torch.from_numpy(rays_o), torch.from_numpy(rays_d),
                             2.0, 6.0, f, f, 8, 16, jitter=jitter)
    loss_t = (out["rgb_fine"] ** 2).sum()
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    g_t = params_from_state_dict(
        {k: t.grad for k, t in m.named_parameters()})
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(g_j)),
                    jax.tree_util.tree_leaves(g_t)):
        assert np.isfinite(b).all()
        rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
        assert rel <= 5e-3, rel


def _roofline_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_roofline_nerf", os.path.join(ROOT, "tools",
                                            "torch_roofline_nerf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode,keys", [
    ("main", ["step_ms", "rays_per_s", "mlp_fwd_ms", "mlp_bwd_ms",
              "mlp_fwd_bwd_ms", "plain_fwd_ms", "plain_fwd_bwd_ms",
              "sample_ms", "composite_ms", "adam_ms", "steps10_ms",
              "steps10_ms_per_step", "mlp_fwd_bwd_tflops",
              "sum_of_parts_ms"]),
    ("fwdwall", ["k3_ms", "k1_ms", "k6_ms", "plain_ms", "k3_tflops",
                 "k6_tflops"]),
])
def test_roofline_tool_runs_on_the_cpu(mode, keys):
    """tools/torch_roofline_nerf.py's run() at batch 4 on the CPU: every
    number is there, and no kernel is launched (the plain versions run)."""
    tool = _roofline_tool()
    res = tool.run(4, mode, "cpu", iters=2)
    assert res["mode"] == mode and res["points"] == 4 * 256
    for k in keys:
        assert 0 < res[k] < float("inf"), k
    assert set(res["launches"]) and not any(res["launches"].values())

"""The port's NeRF MLP and its kernels' plain versions
(msra_practice_project_tpu_torch.models.nerf, ops.kernels.nerf_mlp) against
the JAX package on the CPU.  The JAX Pallas kernel runs in interpret mode, as
its own tests run it; weights reach the port through ``weights.py``.

The CUDA kernels themselves run only on a card: ``python3 chip_smoke.py``
holds them against these plain versions there."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.core import nn as jnn
from msra_practice_project_tpu.models.nerf import nerf_model as jnerf_model
from msra_practice_project_tpu.ops.pallas import nerf_mlp as JK
from msra_practice_project_tpu_torch.core import nn as tnn
from msra_practice_project_tpu_torch.models.nerf import nerf_model
from msra_practice_project_tpu_torch.ops.kernels import nerf_mlp as K
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
    m.load_state_dict(nerf_state_dict(_np_tree(p)))
    return p, m


def _points(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 6)).astype(np.float32)


def test_positional_encoding_matches_jax():
    x = _points(50, 0)[:, :3] * 3
    for length in (4, 10):
        ref = np.asarray(jnn.positional_encoding(jnp.asarray(x), length))
        out = tnn.positional_encoding(torch.from_numpy(x), length).numpy()
        assert out.shape == (50, 6 * length)
        np.testing.assert_allclose(out, ref, atol=2e-6)


@pytest.mark.parametrize("act", ["relu", "linear", "sigmoid"])
def test_dense_init_xavier_gain(act):
    g = torch.Generator().manual_seed(0)
    layer = tnn.dense_init(256, 128, act, generator=g)
    bound = tnn.GAINS[act] * math.sqrt(6.0 / (256 + 128))
    assert tnn.GAINS[act] == pytest.approx(jnn.GAINS[act])
    w = layer.weight.detach()
    assert w.shape == (128, 256)
    assert float(w.abs().max()) <= bound
    assert float(w.abs().max()) > 0.99 * bound
    assert float(layer.bias.detach().abs().max()) == 0.0


def test_nerf_model_matches_jax(shared):
    p, m = shared
    x = _points(300, 2).reshape(3, 100, 6)
    ref = np.asarray(jnerf_model(False).apply(p, jnp.asarray(x)))
    with torch.no_grad():
        out = m(torch.from_numpy(x)).numpy()
    assert out.shape == (3, 100, 4)
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_weights_roundtrip_and_siren_not_ported(shared):
    p, m = shared
    back = nerf_params_from_state_dict(m.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(p)),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        nerf_model(use_siren=True)


def test_pack_shapes_and_zero_padding(shared):
    p, m = shared
    packed = {k: t.detach() for k, t in K.pack_nerf_params(m).items()}
    ref = JK.pack_nerf_params(p)
    for k in K.PACK_KEYS:
        assert tuple(packed[k].shape) == K.PACK_SHAPES[k] == ref[k].shape, k
        np.testing.assert_array_equal(packed[k].numpy(),
                                      np.asarray(ref[k]))
    for k, rows in (("W0", 60), ("W5a", 60), ("W9b", 24)):
        assert float(packed[k][rows:].abs().max()) == 0.0
    assert float(packed["Ws"][:, 1:].abs().max()) == 0.0
    assert float(packed["Wr"][:, 3:].abs().max()) == 0.0


def test_layout_tables_are_consistent():
    assert K.ACT_W == 2528 and K.ACT_PAD == 2560
    assert K.ACT_PAD == JK.ACT_PAD and K.ACT_W == JK.ACT_W
    assert K.DELTA_W == 2448
    tasks = K.grad_tasks()
    assert len(tasks) == len(K.PACK_KEYS)
    assert sum(m * n for _, m, _, n, _ in tasks) == K.GRAD_TOTAL
    for (a0, m, d0, n, off), k in zip(tasks, K.PACK_KEYS):
        assert K.GRAD_OFFS[k][0] == off
        assert (a0 == -1) == k.startswith("b")
        assert a0 + m <= K.ACT_W and d0 + n <= K.DELTA_W
        assert m % 8 == 0 or m == 1        # 16-byte loads in the kernel
        assert n % 8 == 0 and d0 % 8 == 0 and (a0 == -1 or a0 % 8 == 0)


def _jax_grads(p, x, dy, bf16):
    """fused_nerf_apply(p, x, bf16, interpret, need_dx=False, save_acts)."""
    def f(p):
        return JK.fused_nerf_apply(p, jnp.asarray(x), bf16, True, False, True)
    out, vjp = jax.vjp(f, p)
    return np.asarray(out), _np_tree(vjp(jnp.asarray(dy))[0])


def _port_grads(m, x, dy, bf16):
    m.zero_grad()
    out = K.fused_nerf_apply(m, torch.from_numpy(x), bf16)
    (out * torch.from_numpy(dy)).sum().backward()
    g = {k: t.grad.clone() for k, t in m.named_parameters()}
    return out.detach().numpy(), nerf_params_from_state_dict(
        {k: v for k, v in g.items()})


def test_plain_fp32_matches_jax_interpret_kernel(shared):
    """fp32 plain fwd-save + bwd-saved vs the Pallas kernel in interpret
    mode, 700 points (not a multiple of any tile)."""
    p, m = shared
    x = _points(700, 3)
    dy = np.random.default_rng(4).normal(size=(700, 4)).astype(np.float32)
    out_j, g_j = _jax_grads(p, x, dy, False)
    out_t, g_t = _port_grads(m, x, dy, False)
    np.testing.assert_allclose(out_t, out_j, atol=2e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g_j),
                    jax.tree_util.tree_leaves(g_t)):
        scale = float(np.abs(a).max()) + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-4)


def test_plain_bf16_matches_jax_interpret_kernel(shared):
    """bf16 plain versions vs the bf16 Pallas kernel (interpret mode): the
    two round operands and stored activations at the same places, so the
    forward agrees to 5e-3 and the gradients to 5e-2 in relative Frobenius
    norm (relu masks flip on bf16-rounded activations, so elementwise
    comparison is meaningless)."""
    p, m = shared
    x = _points(700, 5)
    dy = np.random.default_rng(6).normal(size=(700, 4)).astype(np.float32)
    out_j, g_j = _jax_grads(p, x, dy, True)
    out_t, g_t = _port_grads(m, x, dy, True)
    np.testing.assert_allclose(out_t, out_j, atol=5e-3)
    for a, b in zip(jax.tree_util.tree_leaves(g_j),
                    jax.tree_util.tree_leaves(g_t)):
        rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
        assert rel <= 5e-2, rel


@pytest.mark.parametrize("bf16", [False, True])
def test_fwd_save_plain_matches_jax_kernel_layout(shared, bf16):
    """The plain K1 spills the same activations in the same ACT_SLOTS
    columns as the JAX kernel."""
    p, m = shared
    x = _points(256, 7)
    w, xp, _, _ = JK._prep(p, jnp.asarray(x), bf16)
    out_j, acts_j = JK._fused_forward_save(xp, w, bf16, True, tile=256)
    packed = K.pack_nerf_params(m)
    wk = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS], bf16)
    out_t, acts_t = K.nerf_mlp_fwd_save(K.pad_points(torch.from_numpy(x)),
                                        wk, bf16)
    assert acts_t.dtype == (torch.bfloat16 if bf16 else torch.float32)
    acts_j = np.asarray(acts_j[:256].astype(jnp.float32))
    acts_t = acts_t[:256].float().numpy()
    if bf16:
        rel = np.linalg.norm(acts_t - acts_j) / np.linalg.norm(acts_j)
        assert rel < 1e-2
    else:
        np.testing.assert_allclose(acts_t, acts_j, atol=2e-5)
    np.testing.assert_allclose(out_t[:256].numpy(), np.asarray(out_j[:256]),
                               atol=5e-3 if bf16 else 2e-5)


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch(shared):
    _, m = shared
    K.reset_launch_counts()
    x = torch.from_numpy(_points(130, 8))
    out = K.fused_nerf_apply(m, x, True)
    out.sum().backward()
    assert out.shape == (130, 4)
    assert K.nerf_mlp_fwd_save.launches == 0
    assert K.nerf_mlp_bwd_saved.launches == 0
    assert K.pad_points(x).shape == (256, 8)


def test_fused_apply_refuses_input_gradient(shared):
    _, m = shared
    x = torch.from_numpy(_points(16, 9)).requires_grad_()
    with pytest.raises(NotImplementedError):
        K.fused_nerf_apply(m, x)


def test_wrapper_checks_shapes_before_launch(shared):
    """The CUDA path validates its inputs first; on the CPU a bad point
    count never reaches a kernel either."""
    _, m = shared
    packed = K.pack_nerf_params(m)
    w = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS], True)
    with pytest.raises(ValueError):
        K._check(torch.zeros(100, 8), "x", (128, 8), torch.float32,
                 torch.device("cpu"))
    with pytest.raises(ValueError):
        K._check(w[0].float(), "W0", K.PACK_SHAPES["W0"], torch.bfloat16,
                 torch.device("cpu"))

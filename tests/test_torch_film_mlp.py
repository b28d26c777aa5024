"""The port's FiLM-SIREN trunk, its sine and its kernels' plain versions
(msra_practice_project_tpu_torch.core.nn, ops.kernels.film_mlp) against the
JAX package on the CPU.  The JAX Pallas kernels run in interpret mode, as
its own tests run them (tests/test_pallas.py); weights reach the port
through ``weights.py``.

The CUDA kernels themselves run only on a card: ``python3 chip_smoke.py``
holds them against these plain versions there."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.core import nn as jnn
from msra_practice_project_tpu.models import pigan as jpigan
from msra_practice_project_tpu.ops.pallas import film_mlp as JK
from msra_practice_project_tpu_torch.core import nn as tnn
from msra_practice_project_tpu_torch.models import pigan
from msra_practice_project_tpu_torch.ops.kernels import film_mlp as K
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


def _trunk(use_dir):
    """JAX trunk params and the port's trunk with the same weights."""
    cfg = jpigan.FilmSirenNeRFConfig(use_dir=use_dir)
    p = jpigan.FilmSirenNeRF(cfg).init(jax.random.PRNGKey(0))
    t = pigan.FilmSirenNeRF(pigan.FilmSirenNeRFConfig(use_dir=use_dir))
    t.load_state_dict(state_dict_from_params(_np_tree(p)))
    return p, t


def _inputs(b, p, seed):
    """x [b, p, 6] and film near (gamma=1, beta=0), as tests/test_pallas.py
    draws them, from numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, p, 6)) * 0.3).astype(np.float32)
    film = (rng.normal(size=(b, 9, 512)) * 0.1).astype(np.float32)
    film[..., :256] += 1.0
    return x, film


def _padded(t, x, film, use_dir, bf16):
    """The kernels' inputs: x [b, P_pad, 8] and the kernel weights."""
    packed = K.pack_film_params(dict(t.named_parameters()), use_dir)
    w = K.kernel_weights([packed[k].detach() for k in K.PACK_KEYS], bf16)
    x_pad, _ = K.pad_points(torch.from_numpy(x), x.shape[0])
    return x_pad, torch.from_numpy(film), w


def test_trunk_sine_and_its_derivative_match_jax():
    """Includes exact multiples and half multiples of pi and 2 pi, where the
    range reduction rounds half to even and reflects."""
    k = np.arange(-12, 13)
    v = np.concatenate([np.linspace(-40, 40, 4001), k * np.pi, k * 2 * np.pi,
                        (k + 0.5) * 2 * np.pi, (k + 0.5) * np.pi]
                       ).astype(np.float32)
    for port_fn, jax_fn in ((tnn.fast_sin, jnn.fast_sin),
                            (tnn.trunk_sin, jnn.trunk_sin),
                            (tnn.trunk_sin_vjp, jnn.trunk_sin_vjp)):
        np.testing.assert_allclose(port_fn(torch.from_numpy(v)).numpy(),
                                   np.asarray(jax_fn(jnp.asarray(v))),
                                   atol=1e-6)
    # the derivative is autograd's derivative of the polynomial
    vt = torch.from_numpy(v).requires_grad_()
    tnn.trunk_sin(vt).sum().backward()
    np.testing.assert_allclose(vt.grad.numpy(),
                               tnn.trunk_sin_vjp(vt.detach()).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("use_dir", [True, False])
def test_pack_and_unpack_match_jax(use_dir):
    p, t = _trunk(use_dir)
    params = dict(t.named_parameters())
    packed = K.pack_film_params(params, use_dir)
    ref = JK.pack_film_params(p, use_dir)
    for k in K.PACK_KEYS:
        assert tuple(packed[k].shape) == K.PACK_SHAPES[k] == ref[k].shape, k
        np.testing.assert_array_equal(packed[k].detach().numpy(),
                                      np.asarray(ref[k]))
    # unpacking packed-shaped grads gives JAX's _unpack_grads, transposed,
    # and is autograd's own unpacking of the (differentiable) packing
    rng = np.random.default_rng(0)
    gk = [rng.normal(size=K.PACK_SHAPES[k]).astype(np.float32)
          for k in K.PACK_KEYS]
    got = K.unpack_film_grads([torch.from_numpy(a) for a in gk], use_dir)
    want = state_dict_from_params(_np_tree(
        JK._unpack_grads([jnp.asarray(a) for a in gk], p, use_dir)))
    assert set(got) == set(want) == set(params)
    live = [(packed[k], torch.from_numpy(a))
            for k, a in zip(K.PACK_KEYS, gk) if packed[k].requires_grad]
    auto = torch.autograd.grad([t for t, _ in live], list(params.values()),
                               [a for _, a in live])
    for (name, a), b in zip(params.items(), auto):
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy())
        np.testing.assert_array_equal(got[name].numpy(), b.numpy())
        assert got[name].shape == a.shape


@pytest.mark.parametrize("use_dir", [True, False])
def test_plain_fwd_matches_jax_kernel_and_apply(use_dir):
    """The plain K8 (fp32) against JAX's fused forward in interpret mode and
    against FilmSirenNeRF.apply; the port's plain trunk against apply."""
    p, t = _trunk(use_dir)
    x, film = _inputs(3, 35, 1)
    ref = np.asarray(jpigan.FilmSirenNeRF(
        jpigan.FilmSirenNeRFConfig(use_dir=use_dir)).apply(
            p, jnp.asarray(x), jnp.asarray(film)))
    fused = np.asarray(JK.fused_film_apply(p, jnp.asarray(x),
                                           jnp.asarray(film), use_dir,
                                           False, True))
    x_pad, f, w = _padded(t, x, film, use_dir, False)
    out = K.film_mlp_fwd(x_pad, f, w, False)[:, :35].numpy()
    assert np.all(out[..., 4:] == 0)
    np.testing.assert_allclose(out[..., :4], fused, atol=2e-5)
    np.testing.assert_allclose(out[..., :4], ref, atol=2e-5)
    with torch.no_grad():
        plain = t._apply_plain(torch.from_numpy(x), f).numpy()
    np.testing.assert_allclose(plain, ref, atol=2e-5)


def _jax_bwd(p, x, film, dy, use_dir, bf16, need_dx):
    weights, x_pad, n = JK._prep(p, jnp.asarray(x), jnp.asarray(film),
                                 use_dir)
    b, p_pad = x_pad.shape[:2]
    dy_pad = jnp.zeros((b, p_pad, 8), jnp.float32).at[:, :n, :4].set(
        jnp.asarray(dy))
    dx, dfilm, dw = JK._fused_backward(x_pad, jnp.asarray(film), dy_pad,
                                       weights, bf16, True, need_dx)
    return (None if dx is None else np.asarray(dx)[:, :n],
            np.asarray(dfilm), [np.asarray(a) for a in dw])


def _port_bwd(t, x, film, dy, use_dir, bf16, need_dx):
    x_pad, f, w = _padded(t, x, film, use_dir, bf16)
    n = x.shape[1]
    dy_pad = torch.zeros(x_pad.shape[0], x_pad.shape[1], 8)
    dy_pad[:, :n, :4] = torch.from_numpy(dy)
    dx, dfilm, dw = K.film_mlp_bwd(x_pad, f, dy_pad, w, bf16, need_dx)
    return (None if dx is None else dx[:, :n].numpy(), dfilm.numpy(),
            [a.numpy() for a in dw])


def _scaled_close(a, b, atol):
    scale = float(np.abs(b).max()) + 1e-8
    np.testing.assert_allclose(a / scale, b / scale, atol=atol)


def test_plain_bwd_fp32_matches_jax_interpret_kernel():
    """The plain K7's param, film and x grads against the Pallas backward in
    interpret mode (scaled atol 2e-4, as tests/test_pallas.py), 300 points
    per image (not a multiple of any tile)."""
    p, t = _trunk(True)
    x, film = _inputs(2, 300, 2)
    dy = np.random.default_rng(3).normal(size=(2, 300, 4)).astype(np.float32)
    dx_j, dfilm_j, dw_j = _jax_bwd(p, x, film, dy, True, False, True)
    dx_t, dfilm_t, dw_t = _port_bwd(t, x, film, dy, True, False, True)
    for a, b in zip(dw_t, dw_j):
        _scaled_close(a, b, 2e-4)
    _scaled_close(dfilm_t, dfilm_j, 2e-4)
    _scaled_close(dx_t, dx_j, 2e-4)


def test_plain_bwd_need_dx_false_keeps_param_and_film_grads():
    p, t = _trunk(True)
    x, film = _inputs(2, 64, 4)
    dy = np.random.default_rng(5).normal(size=(2, 64, 4)).astype(np.float32)
    dx_t, dfilm_t, dw_t = _port_bwd(t, x, film, dy, True, False, True)
    dx_f, dfilm_f, dw_f = _port_bwd(t, x, film, dy, True, False, False)
    assert dx_f is None and np.abs(dx_t).max() > 0
    np.testing.assert_array_equal(dfilm_f, dfilm_t)
    for a, b in zip(dw_f, dw_t):
        np.testing.assert_array_equal(a, b)


def test_plain_bwd_bf16_matches_jax_bf16_interpret_kernel():
    """bf16: both round the matmul operands and the stored u_l/h_l at the
    same places (the film backward uses the rounded u), so the gradients
    agree in relative Frobenius norm; elementwise they do not (the two sum
    in different orders, and one bf16 ulp of u moves the sine by ~30 ulps)."""
    p, t = _trunk(True)
    x, film = _inputs(2, 128, 6)
    dy = np.random.default_rng(7).normal(size=(2, 128, 4)).astype(np.float32)
    dx_j, dfilm_j, dw_j = _jax_bwd(p, x, film, dy, True, True, True)
    dx_t, dfilm_t, dw_t = _port_bwd(t, x, film, dy, True, True, True)
    for a, b in zip(dw_t + [dfilm_t, dx_t], dw_j + [dfilm_j, dx_j]):
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel <= 2e-2, rel


def _run(fn, x, film, dy, params):
    """fn(x, film) with x [2, 5, 10, 6]: (out, dx, dfilm, param grads)."""
    xt = torch.from_numpy(x).reshape(2, 5, 10, 6).requires_grad_()
    ft = torch.from_numpy(film).requires_grad_()
    for q in params:
        q.grad = None
    out = fn(xt, ft)
    (out * dy).sum().backward()
    return [out.detach(), xt.grad, ft.grad] + [q.grad for q in params]


@pytest.mark.parametrize("need_dx", [True, False])
def test_fused_function_fp32_matches_autograd_on_cpu(need_dx):
    """fused_film_apply (K8 forward, K7 backward) in fp32 on CPU tensors,
    where both take their plain versions, against autograd of the plain
    trunk: the forward at 2e-5, every gradient at a scaled 2e-4."""
    _, t = _trunk(True)
    params = list(t.parameters())
    x, film = _inputs(2, 50, 8)
    dy = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 5, 10, 4)).astype(np.float32))
    ref = _run(t._apply_plain, x, film, dy, params)
    got = _run(lambda x, f: K.fused_film_apply(
        dict(t.named_parameters()), x, f, True, bf16=False,
        need_dx=need_dx), x, film, dy, params)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=2e-5)
    if not need_dx:
        assert float(got[1].abs().max()) == 0.0
        got, ref = got[2:], ref[2:]
    for a, b in zip(got[1:], ref[1:]):
        _scaled_close(a.numpy(), b.numpy(), 2e-4)


@pytest.mark.parametrize("mode", [1, 2])
def test_trunk_modes_route_through_the_kernels_on_cpu(monkeypatch, mode):
    """MSRA_TPU_FUSED_FILM=1 (the default) and 2 on CPU tensors: the forward
    is K8's plain version in fp32 (mode 1) or in bf16 (mode 2), and every
    gradient is K7's plain version in bf16, unpacked."""
    _, t = _trunk(True)
    params = list(t.parameters())
    x, film = _inputs(2, 50, 11)
    dy = torch.from_numpy(np.random.default_rng(12).normal(
        size=(2, 5, 10, 4)).astype(np.float32))
    monkeypatch.setenv("MSRA_TPU_FUSED_FILM", str(mode))
    got = _run(t, x, film, dy, params)

    x_pad, f, w = _padded(t, x, film, True, True)
    with torch.no_grad():
        out = K.film_mlp_fwd(x_pad, f, _padded(t, x, film, True, mode == 2)[2],
                             mode == 2)[:, :50, :4]
    dy_pad = torch.zeros(2, 64, 8)
    dy_pad[:, :50, :4] = dy.reshape(2, 50, 4)
    dx, dfilm, dw = K.film_mlp_bwd(x_pad, f, dy_pad, w, True, True)
    g = K.unpack_film_grads(dw, True)
    want = [out.reshape(got[0].shape), dx[:, :50, :6], dfilm] + [
        g[n] for n, _ in t.named_parameters()]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.reshape(a.shape).numpy())


def test_mode1_primal_matches_jax_hybrid_primal_on_cpu(monkeypatch):
    """Mode 1's forward (K8's plain fp32 version on CPU tensors) against the
    JAX package's _film_trunk_hybrid primal (its XLA trunk) at 2e-5."""
    monkeypatch.setenv("MSRA_TPU_FUSED_FILM", "1")
    p, t = _trunk(True)
    x, film = _inputs(2, 50, 14)
    want = np.asarray(jpigan._film_trunk_hybrid(
        p, jnp.asarray(x), jnp.asarray(film), True, True))
    K.reset_launch_counts()
    with torch.no_grad():
        got = t(torch.from_numpy(x), torch.from_numpy(film)).numpy()
    assert got.shape == want.shape == (2, 50, 4)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert K.film_mlp_fwd.launches == K.film_mlp_fwd.launches_f32 == 0


def _tf32_trunc(a):
    """a with its low 13 bits cleared: the tf32 value the tensor cores read
    from an fp32 container."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(passes):
    """K8's products as the fp32 kernel computes them, for K._mm: the K =
    256 products (W1..W7, W8a) as 3 tf32 products (big(a) big(b) + small(a)
    big(b) + big(a) small(b), small truncated as the tensor cores read it)
    or as 1 (big(a) big(b)); the K = 8 products and the heads in fp32."""

    def mm(a, b, bf16):
        assert not bf16
        if tuple(b.shape) != (K.HID, K.HID):
            return a @ b
        (ab, as_), (bb, bs) = K.tf32_split(a), K.tf32_split(b)
        if passes == 1:
            return ab @ bb
        return _tf32_trunc(as_) @ bb + ab @ bb + ab @ _tf32_trunc(bs)

    return mm


def test_3xtf32_emulation_meets_the_fp32_gate_and_1xtf32_does_not(
        monkeypatch):
    """The plain fp32 K8 with every K = 256 product emulated as the fp32
    kernel computes it (3xTF32) stays within K8's fp32 gate (1e-4 of
    max|ref|, PERF.md) of the exact plain version on a JAX-initialised
    trunk; one tf32 product per K = 256 product does not (the w0 = 30 sine
    amplifies its 10-bit mantissa)."""
    _, t = _trunk(True)
    x, film = _inputs(2, 1024, 15)
    x_pad, f, w = _padded(t, x, film, True, False)
    ref = K.film_mlp_fwd_plain(x_pad, f, w, False)
    scale = float(ref.abs().max())
    errs = {}
    for passes in (3, 1):
        monkeypatch.setattr(K, "_mm", _mm_tf32(passes))
        errs[passes] = float((K.film_mlp_fwd_plain(x_pad, f, w, False)
                              - ref).abs().max()) / scale
    assert errs[3] <= 1e-4, errs
    assert errs[1] > 1e-4, errs


def test_unbatched_film_takes_the_plain_path(monkeypatch):
    """film [9, 512] broadcast over x [R, S, 6] must not reach the kernels
    (they flatten x per film row); it matches the batched call."""
    monkeypatch.setenv("MSRA_TPU_FUSED_FILM", "2")
    _, t = _trunk(True)
    x, film = _inputs(1, 24, 13)
    xt = torch.from_numpy(x).reshape(4, 6, 6)
    ft = torch.from_numpy(film[0])
    assert not t._kernel_batched(xt, ft)
    K.reset_launch_counts()
    with torch.no_grad():
        out = t(xt, ft)
        ref = t._apply_plain(xt[None], ft[None])[0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch():
    _, t = _trunk(True)
    K.reset_launch_counts()
    x, film = _inputs(1, 64, 10)
    x_pad, f, w = _padded(t, x, film, True, True)
    K.film_mlp_fwd(x_pad, f, w, True)
    K.film_mlp_bwd(x_pad, f, torch.zeros_like(x_pad), w, True, False)
    assert K.film_mlp_fwd.launches == 0 and K.film_mlp_bwd.launches == 0


def test_layout_tables_match_the_cuda_source():
    assert (K.ACT_W, K.U_W, K.DELTA_W, K.SUM_W) == (2312, 2304, 2320, 6928)
    assert K.GRAD_TOTAL - K.BIAS_OFF == 9 * 256 + 16
    assert K.GRAD_KEYS[-11:] == [f"b{i}" for i in range(9)] + ["bs", "br"]
    tasks = K.grad_tasks()
    assert len(tasks) == 12
    assert max(off + m * n for _, m, _, n, off in tasks) == K.BIAS_OFF
    for a0, m, d0, n, _ in tasks:
        assert a0 % 8 == 0 and d0 % 8 == 0 and m % 8 == 0 and n % 8 == 0
        assert a0 + m <= K.ACT_W and d0 + n <= K.DELTA_W
    # the constants the wrapper mirrors, as the CUDA source defines them
    src = open(os.path.join(os.path.dirname(K.__file__), "csrc",
                            "film_mlp.cu")).read()
    hdr = open(os.path.join(os.path.dirname(K.__file__), "csrc",
                            "tile_mm.cuh")).read()

    def const(name, text=src):
        return int(re.search(rf"\b{name} = (\d+)[,;]", text).group(1))

    assert (const("IN_PAD"), const("OUT_PAD"), const("N_FILM"),
            const("PT_MULT")) == (K.IN_PAD, K.OUT_PAD, K.N_FILM, K.PT_MULT)
    assert (const("HID", hdr), const("KS", hdr)) == (K.HID, 32)
    # the bf16 per-tile pass's machinery, shared with nerf_mlp.cu
    assert (const("TC_STAGES", hdr), const("TC_TILE", hdr)) == (
        K.TC_STAGES, K.TC_TILE)
    assert "TC_STAGE_BYTES = KS * HID * 2;" in hdr
    assert K.TC_STAGE_BYTES == 32 * K.HID * 2
    assert "TC_A_BLOCK = TC_TILE * 64 * 2;" in hdr
    assert K.TC_A_BLOCK == K.TC_TILE * 64 * 2
    for name, v in (("ACT_W", K.ACT_W), ("U_W", K.U_W),
                    ("DELTA_W", K.DELTA_W), ("SUM_W", K.SUM_W)):
        assert re.search(rf"\b{name} = .*// {v}\n", src), name
    # scratch stays in budget at the fine pass's shape
    cb = K.chunk_images(64, 24576, True)
    assert 1 <= cb < 64
    assert cb * 24576 * (K.ACT_W + K.U_W + K.DELTA_W) * 2 <= K.SCRATCH_BYTES


def test_wrappers_check_shapes():
    with pytest.raises(ValueError):
        K._check_inputs(torch.zeros(1, 100, 8), torch.zeros(1, 9, 512), [],
                        True)
    with pytest.raises(ValueError):
        K._check(torch.zeros(2, 8), "x", (2, 8), torch.bfloat16,
                 torch.device("cpu"))

"""The port's rendering ops (msra_practice_project_tpu_torch.ops) against the
JAX package's, on the CPU, at fp32.  Inputs, poses and stratified jitter are
made with numpy or rebuilt from the JAX key and handed to both."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.ops import composite as jcomp
from msra_practice_project_tpu.ops import rays as jrays
from msra_practice_project_tpu.ops import render as jrender
from msra_practice_project_tpu.ops import sampling as jsamp
from msra_practice_project_tpu_torch.ops import composite, rays, render, sampling

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


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# rays and poses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r,theta,phi", [(4.0, 30.0, -20.0),
                                         (1.5, -120.0, 10.0)])
def test_camera_pose_and_rays_match_jax(r, theta, phi):
    pose_j = np.asarray(jrays.camera_pose_deg(r, theta, phi))
    pose_t = rays.camera_pose_deg(r, theta, phi)
    np.testing.assert_allclose(pose_t.numpy(), pose_j, atol=1e-6)
    np.testing.assert_allclose(
        rays.camera_pose(r, np.radians(theta), np.radians(phi)).numpy(),
        pose_j, atol=1e-6)
    assert np.allclose(rays.pose_to_camera_pos(pose_t.numpy()),
                       jrays.pose_to_camera_pos(pose_j), atol=1e-4)
    ro_j, rd_j = jrays.get_rays(7, 5, 11.0, jnp.asarray(pose_j))
    ro_t, rd_t = rays.get_rays(7, 5, 11.0, _t(pose_j))
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), atol=1e-6)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), atol=1e-6)
    fo, fd = rays.get_rays_flat(7, 5, 11.0, _t(pose_j))
    assert fo.shape == fd.shape == (35, 3)
    np.testing.assert_array_equal(rays.BLENDER_COORD, jrays.BLENDER_COORD)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("perturb", [True, False])
def test_stratified_samples_with_injected_jitter(perturb):
    key = jax.random.PRNGKey(3)
    z_j, mids_j = jsamp.stratified_samples(key, 2.0, 6.0, 16, (9,),
                                           perturb=perturb)
    jitter = _t(jax.random.uniform(key, (9, 16), jnp.float32))
    z_t, mids_t = sampling.stratified_samples(2.0, 6.0, 16, (9,), perturb,
                                              jitter=jitter)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-5)
    np.testing.assert_allclose(mids_t.numpy(), np.asarray(mids_j), atol=1e-5)


def test_stratified_samples_generator_in_intervals():
    g = torch.Generator().manual_seed(0)
    z, mids = sampling.stratified_samples(2.0, 6.0, 64, (128,), generator=g)
    base = np.linspace(2.0, 6.0, 64)
    lower = np.concatenate([[base[0]], (base[1:] + base[:-1]) / 2])
    upper = np.concatenate([(base[1:] + base[:-1]) / 2, [base[-1]]])
    assert (z.numpy() >= lower - 1e-6).all() and (z.numpy() <= upper + 1e-6).all()
    assert mids.shape == (128, 63)


@pytest.mark.parametrize("case", ["random", "zero_weights", "peaked", "nc2"])
def test_sample_pdf_matches_jax(case, rng):
    if case == "nc2":
        # nc=2: one midpoint bin edge, empty weights
        bins = np.full((5, 1), 4.0, np.float32)
        w = np.zeros((5, 0), np.float32)
    else:
        bins = np.sort(rng.uniform(2, 6, size=(6, 15)), -1).astype(np.float32)
        w = rng.uniform(0, 1, size=(6, 14)).astype(np.float32)
        if case == "zero_weights":  # exercises the denom < 1e-5 guard
            w[:] = 0.0
        elif case == "peaked":
            w[:] = 0.0
            w[:, 5] = 3.0
    ref = np.asarray(jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 24))
    out = sampling.sample_pdf(_t(bins), _t(w), 24).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_sample_pdf_rejects_bad_shapes():
    with pytest.raises(ValueError):
        sampling.sample_pdf(torch.zeros(2, 5), torch.zeros(2, 5), 4)


# ---------------------------------------------------------------------------
# compositing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["inf", "mean"])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_raw_to_outputs_matches_jax(mode, white_bkgd, rng):
    raw = rng.uniform(0, 1, size=(7, 12, 4)).astype(np.float32)
    raw[..., 3] *= 3.0
    z = np.sort(rng.uniform(2, 6, size=(7, 12)), -1).astype(np.float32)
    rd = rng.normal(size=(7, 3)).astype(np.float32)
    ref = jcomp.raw_to_outputs(jnp.asarray(raw), jnp.asarray(z),
                               jnp.asarray(rd), white_bkgd, mode)
    out = composite.raw_to_outputs(_t(raw), _t(z), _t(rd), white_bkgd, mode)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_near_opaque_gradients_match_float64():
    """Behind a near-opaque sample (optical depth 8..16) the transmittance is
    1e-4..1e-7.  Log-space transmittance keeps it, and so the gradient of
    the pixel colour w.r.t. each sample's rgb (its weight), accurate to
    ~1e-6 relative in fp32.  cumprod(1 - alpha + 1e-10) loses it to the
    cancellation in 1 - alpha: this test fails if that form comes back."""
    S = 24
    d = 4.0 / (S - 1)
    raw = np.random.default_rng(0).uniform(0, 1, size=(16, S, 4))
    raw[..., 3] = 0.2 / d                          # optical depth 0.2 each
    raw[:, 4, 3] = np.linspace(8, 16, 16) / d      # the near-opaque sample
    z = np.broadcast_to(np.linspace(2, 6, S), (16, S))
    rd = np.tile([0.0, 0.0, -1.0], (16, 1))

    def grad(dtype):
        r = torch.tensor(raw, dtype=dtype, requires_grad=True)
        rgb, _, _, _ = composite.raw_to_outputs(
            r, torch.tensor(z, dtype=dtype), torch.tensor(rd, dtype=dtype))
        rgb.sum().backward()
        return r.grad.double().numpy()

    g32, g64 = grad(torch.float32), grad(torch.float64)
    assert np.isfinite(g32).all()
    assert np.abs(g32[:, :-1, 3]).max() < 1e3
    np.testing.assert_allclose(g32[..., :3], g64[..., :3], rtol=1e-4)
    np.testing.assert_allclose(g32[..., 3], g64[..., 3],
                               atol=1e-5 * np.abs(g64[..., 3]).max())


# ---------------------------------------------------------------------------
# render_rays / render_image
# ---------------------------------------------------------------------------


def _field_jax(x):
    p, d = x[..., :3], x[..., 3:6]
    sigma = jax.nn.relu(1.0 - jnp.linalg.norm(p, axis=-1, keepdims=True)) * 8
    rgb = jax.nn.sigmoid(2.0 * p + 0.5 * d)
    return jnp.concatenate([rgb, sigma], -1)


def _field_torch(x):
    p, d = x[..., :3], x[..., 3:6]
    sigma = torch.relu(1.0 - torch.linalg.norm(p, dim=-1, keepdim=True)) * 8
    rgb = torch.sigmoid(2.0 * p + 0.5 * d)
    return torch.cat([rgb, sigma], -1)


def test_render_rays_matches_jax(rng):
    ro = (rng.normal(size=(20, 3)) * 0.2 + [0, 0, 4.0]).astype(np.float32)
    rd = (-ro / np.linalg.norm(ro, axis=-1, keepdims=True)
          + 0.2 * rng.normal(size=(20, 3))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jrender.render_rays(key, jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0,
                              _field_jax, _field_jax, 16, 32)
    jitter = _t(jax.random.uniform(key, (20, 16), jnp.float32))
    out = render.render_rays(_t(ro), _t(rd), 2.0, 6.0, _field_torch,
                             _field_torch, 16, 32, jitter=jitter)
    assert out["acc_fine"].max() > 0.5      # the rays do hit the sphere
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_render_image_edge_padding_matches_jax():
    """7x5 image in tiles of 8 rays: the last tile is edge-padded."""
    pose = jrays.camera_pose_deg(4.0, 20.0, -30.0)
    field = jax.tree_util.Partial(_field_jax)
    ref = jrender.render_image(jax.random.PRNGKey(0), 7, 5, 6.0, pose, 2.0,
                               6.0, field, field, 8, 8, chunk=8,
                               perturb=False)
    out = render.render_image(7, 5, 6.0, _t(pose), 2.0, 6.0, _field_torch,
                              _field_torch, 8, 8, chunk=8, perturb=False,
                              device="cpu")
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# ---------------------------------------------------------------------------
# isolation of the port from JAX
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port (and chip_smoke.py) loads no JAX
    and no module of msra_practice_project_tpu.  Exact names: the JAX
    package's name is a prefix of the port's."""
    code = r"""
import importlib, pkgutil, sys
import msra_practice_project_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # noqa: F401
bad = [m for m in sys.modules
       if m in ("jax", "jaxlib", "optax", "flax", "msra_practice_project_tpu")
       or m.startswith(("jax.", "jaxlib.", "optax.", "flax.",
                        "msra_practice_project_tpu."))]
assert len(names) >= 15, names
print("BAD", bad)
sys.exit(1 if bad else 0)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr

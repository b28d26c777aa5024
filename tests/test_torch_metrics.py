"""The port's image metrics and LPIPS (msra_practice_project_tpu_torch.core.
metrics, core.lpips) against the JAX package's, on the CPU.

The float64 host metrics (SSIM, MS-SSIM, the Frechet distance) are the same
arithmetic in both packages: 1e-10.  PSNR is fp32 in JAX: 1e-6 relative.
The convolutional ones (the random-conv feature distance, LPIPS) run in fp32
in both: 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msra_practice_project_tpu.core import lpips as jlpips
from msra_practice_project_tpu.core import metrics as jmetrics
from msra_practice_project_tpu_torch.core import lpips, metrics
from msra_practice_project_tpu_torch.weights import (
    lpips_state_dict_from_params)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and idle OpenMP workers
    spinning after every op would take cores from the other processes of a
    parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rng, shape, noise=0.1):
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=noise, size=shape), 0, 1)
    return a, b.astype(np.float32)


@pytest.mark.parametrize("shape", [(24, 20, 3), (2, 3, 40, 36), (96, 96, 3)])
def test_host_metrics_match_jax(rng, shape):
    """SSIM (also per image), MS-SSIM (1, 2 and 4 scales by size), PSNR and
    the no-weights perceptual distance, on numpy arrays and on tensors."""
    a, b = _pair(rng, shape)
    for x, y in ((a, b), (torch.from_numpy(a), torch.from_numpy(b))):
        assert metrics.ssim(x, y) == pytest.approx(
            jmetrics.ssim(a, b), rel=1e-10, abs=1e-12)
        np.testing.assert_allclose(
            metrics.ssim(x, y, size_average=False),
            jmetrics.ssim(a, b, size_average=False), rtol=1e-10)
        assert metrics.ms_ssim(x, y) == pytest.approx(
            jmetrics.ms_ssim(a, b), rel=1e-10)
        assert metrics.psnr(x, y) == pytest.approx(
            float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)
        d, label = metrics.perceptual_distance(x, y)
        jd, jlabel = jmetrics.perceptual_distance(a, b)
        assert label == jlabel == "1-msssim"
        assert d == pytest.approx(jd, rel=1e-10, abs=1e-12)
    assert metrics.psnr(None, mse_value=1e-3) == pytest.approx(30.0)
    with pytest.raises(TypeError):
        metrics.psnr(a)


def test_frechet_and_feature_distance_match_jax(rng):
    """The random-conv embedding's weights are the same numpy draws; the
    embedding and the distance against JAX's; the distance is 0 for equal
    sets and grows with the difference."""
    for pj, pt in zip(jmetrics._random_feature_params(3),
                      metrics._random_feature_params(3)):
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    fa, fb = rng.normal(size=(9, 16)), rng.normal(size=(7, 16)) + 0.3
    assert metrics.frechet_from_features(fa, fb) == pytest.approx(
        jmetrics.frechet_from_features(fa, fb), rel=1e-10)
    assert metrics.frechet_from_features(
        torch.from_numpy(fa), torch.from_numpy(fb)) == pytest.approx(
        jmetrics.frechet_from_features(fa, fb), rel=1e-10)

    imgs_a = rng.uniform(size=(6, 32, 32, 3)).astype(np.float32)
    imgs_b = np.clip(imgs_a * 0.7 + 0.2, 0, 1).astype(np.float32)
    params = metrics._random_feature_params(0)
    emb = metrics._rf_embed(imgs_a, params).numpy()
    jemb = np.asarray(jmetrics._rf_embed(jnp.asarray(imgs_a),
                                         jmetrics._random_feature_params(0)))
    np.testing.assert_allclose(emb, jemb, rtol=1e-5,
                               atol=1e-5 * np.abs(jemb).max())
    d = metrics.feature_distance(imgs_a, imgs_b)
    assert d == pytest.approx(jmetrics.feature_distance(imgs_a, imgs_b),
                              rel=1e-5)
    assert d > 0
    assert metrics.feature_distance(imgs_a, imgs_a) == 0.0


def _port_lpips(jparams):
    model = lpips.LPIPS()
    model.load_state_dict(lpips_state_dict_from_params(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return model


def test_lpips_matches_jax_on_shared_random_weights(rng):
    """JAX's random_init parameters through the weight bridge: the same
    distance on an HWC pair and per image on an NCHW batch."""
    jl = jlpips.LPIPS.random_init(jax.random.PRNGKey(0))
    model = _port_lpips(jl.params)
    a, b = _pair(rng, (64, 64, 3), noise=0.3)
    ref = float(jl(a, b))
    assert float(model(a, b)) == pytest.approx(ref, rel=1e-5)
    assert float(model(torch.from_numpy(a), b)) == pytest.approx(ref,
                                                                 rel=1e-5)
    batch_a = np.stack([a, b]).transpose(0, 3, 1, 2)
    batch_b = np.stack([b, a * 0.5]).transpose(0, 3, 1, 2)
    got = model(batch_a, batch_b).numpy()
    want = np.asarray(jl(jnp.asarray(batch_a), jnp.asarray(batch_b)))
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lpips_random_init_is_a_distance(rng):
    """The port's own random weights (from a torch.Generator): zero on equal
    images, positive on a noisy copy, the same weights from the same seed."""
    lp = lpips.LPIPS.random_init(torch.Generator().manual_seed(0))
    again = lpips.LPIPS.random_init(torch.Generator().manual_seed(0))
    for k, v in lp.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k
    a, b = _pair(rng, (64, 64, 3), noise=0.3)
    assert abs(float(lp(a, a))) < 1e-6
    assert float(lp(a, b)) > 0


def test_lpips_checkpoint_matches_jax(tmp_path, rng):
    """torchvision- and lpips-style state dicts written to tmp_path, read
    by both from_torch_checkpoint functions (JAX test_core's round trip):
    the same distance; metrics.lpips reads the directory; without a
    directory it is None and the perceptual distance falls back."""
    alex, in_ch = {}, 3
    for idx, (out_ch, k, _, _) in zip(lpips._TV_IDX, lpips._ALEX_CONVS):
        alex[f"features.{idx}.weight"] = torch.randn(out_ch, in_ch, k, k) \
            / np.sqrt(in_ch * k * k)
        alex[f"features.{idx}.bias"] = 0.1 * torch.randn(out_ch)
        in_ch = out_ch
    lin = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
           for i, (c, *_) in enumerate(lpips._ALEX_CONVS)}
    torch.save(alex, tmp_path / "alexnet.pth")
    torch.save(lin, tmp_path / "lpips_lin.pth")

    a, b = _pair(rng, (64, 64, 3), noise=0.3)
    port = lpips.LPIPS.from_torch_checkpoint(
        str(tmp_path / "alexnet.pth"), str(tmp_path / "lpips_lin.pth"))
    ref = jlpips.LPIPS.from_torch_checkpoint(
        str(tmp_path / "alexnet.pth"), str(tmp_path / "lpips_lin.pth"))
    assert float(port(a, b)) == pytest.approx(float(ref(a, b)), rel=1e-5)
    assert float(port(a, a)) < 1e-6

    v = metrics.lpips(a, b, str(tmp_path))
    assert v == pytest.approx(jmetrics.lpips(a, b, str(tmp_path)), rel=1e-5)
    assert metrics.lpips(a, b, None) is None
    assert metrics.lpips(a, b, str(tmp_path / "missing")) is None
    d, label = metrics.perceptual_distance(a, b, str(tmp_path))
    assert label == "lpips-alex" and d == pytest.approx(v)

    torch.save({"other.weight": torch.ones(1)}, tmp_path / "bad_lin.pth")
    with pytest.raises(ValueError, match="linear-head"):
        lpips.LPIPS.from_torch_checkpoint(str(tmp_path / "alexnet.pth"),
                                          str(tmp_path / "bad_lin.pth"))

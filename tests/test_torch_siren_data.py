"""The port's SIREN data modules (msra_practice_project_tpu_torch.data.image,
data.pointcloud) against the JAX package's, on the CPU.  Both are numpy, so
the coordinate buffer, the synthetic image and the synthetic clouds must be
bitwise equal."""

import numpy as np
import pytest
import scipy.io
from PIL import Image

from msra_practice_project_tpu.data import image as jimage
from msra_practice_project_tpu.data import pointcloud as jpointcloud
from msra_practice_project_tpu_torch.data import image, pointcloud


@pytest.mark.parametrize("shuffle", [True, False])
def test_image_to_coords_is_bitwise_jax(shuffle):
    img = image.make_synthetic_image(24, seed=2)
    got = image.image_to_coords(img, shuffle=shuffle, seed=5)
    want = jimage.image_to_coords(img, shuffle=shuffle, seed=5)
    assert got.dtype == np.float32 and got.shape == (24 * 24, 3)
    np.testing.assert_array_equal(got, want)
    if not shuffle:   # x over width, y over height, then the value
        step = np.float32(np.linspace(-1, 1, 24)[1])
        np.testing.assert_array_equal(got[1, :2], [step, -1])
        np.testing.assert_array_equal(got[24, :2], [-1, step])
        np.testing.assert_array_equal(got[:, 2], img.reshape(-1))


@pytest.mark.parametrize("size", [16, 256])
def test_synthetic_image_is_bitwise_jax(size):
    got = image.make_synthetic_image(size)
    np.testing.assert_array_equal(got, jimage.make_synthetic_image(size))
    assert got.shape == (size, size, 1) and 0 <= got.min() < got.max() <= 1


def test_load_image_grayscale_matches_jax(tmp_path, rng):
    path = str(tmp_path / "rgb.png")
    Image.fromarray(rng.integers(0, 256, size=(9, 11, 3),
                                 dtype=np.uint8)).save(path)
    got = image.load_image_grayscale(path)
    assert got.shape == (9, 11, 1)
    np.testing.assert_array_equal(got, jimage.load_image_grayscale(path))


def test_synthetic_sphere_cloud_is_bitwise_jax():
    got = pointcloud.make_synthetic_sphere_cloud(1000, 0.6, seed=3)
    np.testing.assert_array_equal(
        got, jpointcloud.make_synthetic_sphere_cloud(1000, 0.6, seed=3))
    np.testing.assert_allclose(np.linalg.norm(got[:, :3], axis=1), 0.6,
                               rtol=1e-6)
    np.testing.assert_allclose(got[:, :3], 0.6 * got[:, 3:], atol=1e-7)


@pytest.mark.parametrize("suffix", [".npz", ".mat", ".npy"])
def test_load_point_cloud_round_trips(suffix, tmp_path):
    """A cloud written as .npz / .mat (the reference's ``p`` array) / .npy
    reads back as float32 ``[N, 6]``, as the JAX loader reads it."""
    cloud = pointcloud.make_synthetic_sphere_cloud(50, seed=1).astype(
        np.float64)
    path = str(tmp_path / f"c{suffix}")
    if suffix == ".npz":
        np.savez(path, p=cloud)
    elif suffix == ".mat":
        scipy.io.savemat(path, {"p": cloud})
    else:
        np.save(path, cloud)
    got = pointcloud.load_point_cloud(path)
    assert got.dtype == np.float32 and got.shape == (50, 6)
    np.testing.assert_array_equal(got, cloud.astype(np.float32))
    np.testing.assert_array_equal(got, jpointcloud.load_point_cloud(path))


def test_load_point_cloud_rejects_other_shapes(tmp_path):
    path = str(tmp_path / "bad.npy")
    np.save(path, np.zeros((10, 3)))
    with pytest.raises(ValueError, match=r"\[N, 6\]"):
        pointcloud.load_point_cloud(path)


@pytest.mark.parametrize("closed", [False, True])
def test_dem_cloud_is_bitwise_jax(closed):
    """The real-terrain cloud from matplotlib's Jacksboro Fault DEM (the
    ``--real`` SDF gate's data), open sheet or closed block."""
    got = pointcloud.make_dem_cloud(n=3000, seed=2, closed=closed)
    want = jpointcloud.make_dem_cloud(n=3000, seed=2, closed=closed)
    assert got.shape == (3000, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.linalg.norm(got[:, 3:], axis=1), 1.0,
                               rtol=1e-5)
    h, x, y = pointcloud.load_dem_heightfield()
    hj, xj, yj = jpointcloud.load_dem_heightfield()
    for a, b in ((h, hj), (x, xj), (y, yj)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["grace_hopper.jpg",
                                  "jacksboro_fault_dem.npz"])
def test_sample_data_is_matplotlibs_file_byte_for_byte(name):
    """The --real gates' data in the port (data/sample_data/) are the
    files the JAX tools read from matplotlib's sample data, byte for byte."""
    import os

    import matplotlib.cbook as cbook

    from msra_practice_project_tpu_torch.data import SAMPLE_DATA
    with open(os.path.join(SAMPLE_DATA, name), "rb") as a, open(
            cbook.get_sample_data(name, asfileobj=False), "rb") as b:
        assert a.read() == b.read()


def test_dem_reads_the_repos_copy_and_a_missing_file_raises(monkeypatch,
                                                            tmp_path):
    """No matplotlib fallback: with the copy gone, loading raises."""
    before = pointcloud.load_dem_heightfield()[0]
    assert before.shape == (344, 403)
    monkeypatch.setattr(pointcloud, "SAMPLE_DATA", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        pointcloud.load_dem_heightfield()

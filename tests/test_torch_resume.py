"""Exact resume of the port's NeRF trainer
(msra_practice_project_tpu_torch.train.train_nerf) on the CPU: the batch
stream is a pure function of (seed, config, step), so a run killed and
resumed reproduces the uninterrupted run, as tests/test_train.py holds the
JAX trainer (its :193 and :757 cases)."""

import numpy as np
import pytest
import torch

from msra_practice_project_tpu_torch import dryrun
from msra_practice_project_tpu_torch.core.config import (
    NERF_TRAIN_DEFAULTS, resolve)
from msra_practice_project_tpu_torch.core.logging import MetricLogger
from msra_practice_project_tpu_torch.parallel import mesh
from msra_practice_project_tpu_torch.train import train_nerf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and idle OpenMP workers
    spinning after every op would take cores from the other processes of a
    parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# data_size 8 -> 3 images x 64 rays = 192 rays: batch 64 gives epochs of 3
# steps, boundaries at steps 6 (before the kill), 9 and 12 (after it); a
# batch of 256 is larger than the buffer, which then reshuffles at every
# step after the start-up.
COMMON = dict(data_path="/nonexistent", iterations=14, start_up_itrs=3,
              render_coarse_sample_num=4, render_fine_sample_num=4,
              i_print=100, i_image=100, data_size=8)


def _cfg(tmp_path, name, **kw):
    return resolve(dict(COMMON, output_path=str(tmp_path),
                        experiment_name=name, **kw), NERF_TRAIN_DEFAULTS)


@pytest.mark.parametrize("batch_size", [64, 256])
def test_resumed_run_matches_the_uninterrupted_one(tmp_path, batch_size):
    """14 steps against 8 and a resumed 6, across the start-up phase and
    epoch boundaries on both sides of the kill: losses and weights at
    1e-6 (JAX tests/test_train.py:193)."""
    full = train_nerf.train(_cfg(tmp_path, "full", i_save=14,
                                 batch_size=batch_size), device="cpu")
    train_nerf.train(_cfg(tmp_path, "kill", i_save=8, iterations=8,
                          batch_size=batch_size), device="cpu")
    res = train_nerf.train(_cfg(tmp_path, "kill", i_save=8,
                                batch_size=batch_size), device="cpu")
    assert res["state"]["step"] == 14 and res["state"]["opt"].count == 14
    np.testing.assert_allclose(full["log"]["loss"], res["log"]["loss"],
                               rtol=1e-6)
    for m_full, m_res in zip(full["models"], res["models"]):
        for a, b in zip(m_full.parameters(), m_res.parameters()):
            np.testing.assert_allclose(b.detach().numpy(),
                                       a.detach().numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_resume_under_data_parallelism(tmp_path):
    """The same kill at step 8 under 2 gloo ranks (batch 64, 32 rays a
    rank): the resumed run's merged log.npy reproduces the uninterrupted
    DP run's 14 losses at 1e-6 (JAX tests/test_train.py:757)."""
    kw = dict(batch_size=64, i_save=8)
    mesh.spawn(dryrun.run_trainer, 2, args=(
        "train_nerf", _cfg(tmp_path, "m_full", **kw), "cpu"))
    mesh.spawn(dryrun.run_trainer, 2, args=(
        "train_nerf", _cfg(tmp_path, "m_kill", iterations=8, **kw), "cpu"))
    logs = mesh.spawn(dryrun.run_trainer, 2, args=(
        "train_nerf", _cfg(tmp_path, "m_kill", **kw), "cpu"))
    full = MetricLogger.load(str(tmp_path / "m_full" / "log.npy"))["loss"]
    res = MetricLogger.load(str(tmp_path / "m_kill" / "log.npy"))["loss"]
    assert len(full) == len(res) == 14 and np.isfinite(full).all()
    np.testing.assert_allclose(full, res, rtol=1e-6)
    assert logs[0]["loss"] == logs[1]["loss"] == list(res)


def test_eval_images_leave_the_loss_history_unchanged(tmp_path):
    """The eval render at i_image draws from its own generator: rendering
    every 4 steps leaves every loss as it is without renders."""
    quiet = train_nerf.train(_cfg(tmp_path, "quiet", iterations=8,
                                  i_save=100, batch_size=64), device="cpu")
    busy = train_nerf.train(_cfg(tmp_path, "busy", iterations=8, i_save=100,
                                 batch_size=64, i_image=4), device="cpu")
    assert (tmp_path / "busy" / "000004.png").exists()
    assert (tmp_path / "busy" / "000008.png").exists()
    np.testing.assert_array_equal(quiet["log"]["loss"], busy["log"]["loss"])

"""The port's step profiler, NaN debugging and watchdog wiring
(msra_practice_project_tpu_torch.core.diagnostics and the four trainers)
on the CPU."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from msra_practice_project_tpu_torch.core import diagnostics
from msra_practice_project_tpu_torch.core.config import (
    NERF_TRAIN_DEFAULTS, PIGAN_TRAIN_DEFAULTS, SIREN_IMG_DEFAULTS,
    SIREN_SDF_DEFAULTS, resolve)
from msra_practice_project_tpu_torch.models import pigan
from msra_practice_project_tpu_torch.train import (train_img, train_nerf,
                                                   train_pigan, train_sdf)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and idle OpenMP workers
    spinning after every op would take cores from the other processes of a
    parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRAINERS = {
    "nerf": (train_nerf, NERF_TRAIN_DEFAULTS, dict(
        data_path="/nonexistent", batch_size=64, start_up_itrs=0,
        render_coarse_sample_num=4, render_fine_sample_num=4, data_size=8)),
    "pigan": (train_pigan, PIGAN_TRAIN_DEFAULTS, dict(
        data_path="/nonexistent", z_dim=32, render_coarse_sample_num=2,
        render_fine_sample_num=4, fade_in_itrs=[0], batch_size=[2],
        resolution=[8], data_n=4)),
    "img": (train_img, SIREN_IMG_DEFAULTS, dict(batch_size=64,
                                                data_size=16)),
    "sdf": (train_sdf, SIREN_SDF_DEFAULTS, dict(
        batch_size=64, data_path="", data_points=256, i_mesh=100, mesh_n=8,
        final_mesh_n=8)),
}


def _run(kind, tmp_path, iterations, name=None, **kw):
    mod, defaults, base = TRAINERS[kind]
    its = [iterations] if kind == "pigan" else iterations
    cfg = resolve(dict(base, output_path=str(tmp_path),
                       experiment_name=name or kind, iterations=its,
                       i_print=100, i_save=100, i_image=100, **kw), defaults)
    return mod.train(cfg, device="cpu")


def _trace_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_step_profiler_traces_only_its_window(tmp_path):
    """Steps (10, 13] of a 20-step loop, labelled per step: the trace holds
    steps 11-13 and no other; a loop that ends inside the window is traced
    up to its last step; steps=0 traces nothing."""
    prof = diagnostics.StepProfiler(str(tmp_path / "a"), 3, device="cpu")
    for step in range(1, 21):
        prof.tick(step)
        with torch.profiler.record_function(f"step_{step}"):
            torch.ones(8).mul_(step)
    prof.stop()
    assert os.listdir(tmp_path / "a" / "profile") == \
        ["trace_steps_11-13.json"]
    names = _trace_names(prof.path)
    assert {f"step_{s}" for s in (11, 12, 13)} <= names
    assert not {f"step_{s}" for s in (10, 14, 20)} & names

    prof = diagnostics.StepProfiler(str(tmp_path / "b"), 5, skip=2)
    for step in range(1, 5):
        prof.tick(step)
    prof.stop()
    assert os.listdir(tmp_path / "b" / "profile") == \
        ["trace_steps_3-4.json"]
    prof = diagnostics.StepProfiler(str(tmp_path / "c"), 0)
    for step in range(1, 30):
        prof.tick(step)
    prof.stop()
    assert prof.path is None and not (tmp_path / "c").exists()


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_profile_steps_in_every_trainer(tmp_path, kind):
    """``profile_steps: 1`` traces step 11 of a 12-step run."""
    _run(kind, tmp_path, 12, profile_steps=1)
    assert os.listdir(tmp_path / kind / "profile") == \
        ["trace_steps_11-11.json"]


def test_profile_steps_and_a_timed_window_are_not_both_taken(tmp_path):
    with pytest.raises(ValueError, match="profile_steps"):
        train_nerf.train(resolve(dict(
            TRAINERS["nerf"][2], output_path=str(tmp_path),
            experiment_name="x", iterations=2, profile_steps=1),
            NERF_TRAIN_DEFAULTS), device="cpu", timed_steps=1,
            window=contextlib.nullcontext())


@contextlib.contextmanager
def _poisoned_nerf_buffer(monkeypatch):
    build = train_nerf.build_ray_buffer

    def poisoned(*args, **kwargs):
        buf = build(*args, **kwargs)
        buf[0, 6] = float("nan")        # a target colour
        return buf

    monkeypatch.setattr(train_nerf, "build_ray_buffer", poisoned)
    yield


def test_debug_nans_raises_on_a_poisoned_batch_and_is_silent_without(
        tmp_path, monkeypatch):
    """With a NaN in the ray buffer, debug_nans stops the run with
    FloatingPointError (anomaly mode names the backward function) and
    turns anomaly mode off again; without debug_nans the run goes on; a
    clean run with debug_nans is silent."""
    clean = _run("nerf", tmp_path, 3, name="clean", debug_nans=True)
    assert np.isfinite(clean["log"]["loss"]).all()
    assert not torch.is_anomaly_enabled()
    with _poisoned_nerf_buffer(monkeypatch):
        with pytest.raises(FloatingPointError, match="nan values"):
            _run("nerf", tmp_path, 3, name="nan", debug_nans=True)
        assert not torch.is_anomaly_enabled()
        out = _run("nerf", tmp_path, 3, name="quiet")
    assert np.isnan(out["log"]["loss"][0])


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_debug_nans_in_every_trainer(tmp_path, monkeypatch, kind):
    """A NaN in the output layer's bias (a weight every step uses) makes
    every trainer's first step raise under debug_nans."""
    def poisoned(factory):
        def make(*args, **kwargs):
            m = factory(*args, **kwargs)
            with torch.no_grad():
                list(m.parameters())[-1].view(-1)[0] = float("nan")
            return m
        return make

    if kind == "pigan":
        monkeypatch.setattr(pigan, "Discriminator",
                            poisoned(pigan.Discriminator))
    else:
        mod = TRAINERS[kind][0]
        name = {"nerf": "nerf_model", "img": "img_model",
                "sdf": "sdf_model"}[kind]
        monkeypatch.setattr(mod, name, poisoned(getattr(mod, name)))
    with pytest.raises(FloatingPointError):
        _run(kind, tmp_path, 2, debug_nans=True)


def test_nan_check_is_a_host_check_of_finite_values():
    on, off = diagnostics.NanDebug(True), diagnostics.NanDebug(False)
    on.check(1, loss=torch.tensor(0.5))
    off.check(1, loss=torch.tensor(float("nan")))
    with pytest.raises(FloatingPointError, match="g_loss is inf at step 7"):
        on.check(7, d_loss=1.0, g_loss=torch.tensor(float("inf")))


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_every_trainer_arms_the_watchdog(tmp_path, monkeypatch, kind):
    """``watchdog_timeout`` arms a watchdog, beaten once per step and
    stopped when the run ends."""
    made = []

    class Recording(diagnostics.Watchdog):
        def __init__(self, timeout_s, log_path=None):
            super().__init__(timeout_s, log_path)
            self.beats = 0
            made.append(self)

        def beat(self, note=""):
            if note.startswith("step"):
                self.beats += 1
            super().beat(note)

    monkeypatch.setattr(diagnostics, "Watchdog", Recording)
    _run(kind, tmp_path, 3, watchdog_timeout=3600)
    assert len(made) == 1
    w = made[0]
    assert w.timeout == 3600 and w.beats == 3 and not w.enabled

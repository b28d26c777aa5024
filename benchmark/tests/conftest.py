"""Tests of the benchmark.  On the CPU they run each cell at a tiny size
through the program's CPU path; the tests marked ``card`` need an NVIDIA
card and skip without one (``python -m pytest benchmark/tests -m card`` on
the card)."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SCENE = {"full_width": 32, "full_height": 32,
         "camera_angle_x": 0.6911112070083618, "radius": 4.0,
         "phi_deg": [-90.0, 0.0]}
# Each cell cut to a size the CPU runs in seconds: widths as configured,
# fewer rays, images and pixels.
TINY = {
    "nerf_lego_b4096": {"config": {"scene": SCENE},
                        "traffic": {"batch_rays": 64, "views": 2}},
    "nerf_lego_view400": {"config": {"scene": SCENE},
                          "traffic": {"chunk": 128}},
    "pigan_test_s0": {"config": {"batch_size": [2, 2],
                                 "resolution": [8, 16]},
                      "traffic": {"real_images": 8}},
    "pigan_test_s1": {"config": {"batch_size": [2, 2],
                                 "resolution": [8, 16]},
                      "traffic": {"real_images": 8}},
}
SEED = 2 ** 33 + 12345


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (CUDA); skipped without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this machine")
    return torch.device("cuda")


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture
def run_tiny():
    """run_cell on the CPU at the cell's tiny size (the look for a card
    skipped), with ``sut`` in the program's place."""
    import time

    from benchmark.harness.cell import run_cell

    def run(cell, sut="program", seed=SEED, seconds=0.2):
        return run_cell(cell, seed, seconds, False, time.time(),
                        device="cpu", sut=sut, overrides=TINY[cell])

    return run

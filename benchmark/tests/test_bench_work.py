"""The FLOP and byte counts of ``benchmark/work`` against counts by hand."""

from __future__ import annotations

import pytest

from benchmark.harness.registry import Registry
from benchmark.work import nerf, peaks, pigan

REG = Registry()
NERF = REG.config("nerf_lego")
PIGAN = REG.config("pigan_test")


def test_nerf_mlp_by_hand():
    # 60->256, 4 x 256->256, (60+256)->256, 2 x 256->256, sigma 256->1,
    # dir 256->256, (256+24)->128, rgb 128->3
    fwd = (60 * 256 + 4 * 256 * 256 + 316 * 256 + 2 * 256 * 256 + 256
           + 256 * 256 + 280 * 128 + 128 * 3)
    assert fwd == 591_488 == nerf.forward_macs(NERF["net"])
    # the same layers without their encoding columns, the first not at all
    dx = (4 * 256 * 256 + 256 * 256 + 2 * 256 * 256 + 256 + 256 * 256
          + 256 * 128 + 128 * 3)
    assert dx == 557_696 == nerf.input_grad_macs(NERF["net"])


def test_nerf_step_and_view_by_hand():
    points = 4096 * (64 + (64 + 128))
    assert nerf.train_step_flops(NERF, 4096) == {
        "bf16": 2 * (2 * 591_488 + 557_696) * points}
    assert nerf.view_flops(NERF, 160_000) == {
        "fp32": 2 * 591_488 * 160_000 * 256}
    # weights and biases of one MLP (8 trunk layers, sigma, dir, view, rgb)
    weights = 591_488 + 256 * 8 + 1 + 256 + 128 + 3
    assert nerf.train_step_mlp_bytes(NERF, 4096) == 4.0 * (
        points * 14 + 2 * 2 * weights)


def test_pigan_trunk_by_hand():
    fwd = 3 * 256 + 7 * 256 * 256 + (256 + 3) * 256 + 256 + 256 * 3
    dx = 7 * 256 * 256 + 256 * 256 + 256 + 256 * 3
    assert pigan.trunk_macs(PIGAN) == (fwd, dx) == (526_848, 525_312)
    stage = {"batch": 64, "resolution": 32, "fade_alpha": -1.0}
    coarse, fine = 64 * 1024 * 8, 64 * 1024 * 24
    assert pigan.points(PIGAN, stage) == (coarse, fine)
    assert pigan.trunk_flops(PIGAN, stage) == {
        "fp32": 2.0 * fwd * 2 * (coarse + fine),
        "bf16": 2.0 * (fwd + dx) * fine}


def _disc_by_hand(n, with_fade):
    """One image at 32x32 (entry block 1), per convolution."""
    convs = [3 * 128 * 1024,                                  # adapters.1
             128 * 256 * 1024, 130 * 256 * 9 * 1024, 258 * 256 * 9 * 1024,
             256 * 400 * 256, 258 * 400 * 9 * 256, 402 * 400 * 9 * 256,
             400 * 400 * 64, 402 * 400 * 9 * 64, 402 * 400 * 9 * 64,
             400 * 400 * 16, 402 * 400 * 9 * 16, 402 * 400 * 9 * 16,
             400 * 1 * 4]                                     # out
    img = convs[0] + (3 * 256 * 256 if with_fade else 0)
    return 2.0 * n * (sum(convs) + img - convs[0]), 2.0 * n * img, \
        2.0 * n * convs[-1]


def test_pigan_iteration_by_hand():
    stage = {"batch": 64, "resolution": 32, "fade_alpha": -1.0}
    f, f_img, f_out = _disc_by_hand(64, False)
    m_fwd = 1024 * 256 + 2 * 256 * 256 + 9 * 256 * 512
    m_dx = m_fwd - 1024 * 256
    got = pigan.iteration_flops(PIGAN, stage)
    trunk = pigan.trunk_flops(PIGAN, stage)
    # D: 2 forwards, R1's input gradient, the loss's weight and input
    # gradients on two paths, R1's double backward; G step: forward and
    # the input gradient
    disc = 2 * f + f + 2 * (2 * f - f_img) + (2 * f - f_out) + 2 * f
    mapping = 2.0 * 64 * (3 * m_fwd + m_dx)
    assert got["bf16"] == trunk["bf16"]
    assert got["fp32"] == pytest.approx(trunk["fp32"] + mapping + disc,
                                        rel=1e-12)


def test_pigan_fade_adds_the_next_adapter():
    convs = pigan.disc_convs(PIGAN, 64, 0.5)
    assert ("adapters.1", 3, 128, 1, 32 * 32) in convs
    assert convs[0] == ("adapters.0", 3, 64, 1, 64 * 64)
    assert not any(c[0] == "adapters.1"
                   for c in pigan.disc_convs(PIGAN, 64, -1.0))


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds({"bf16": 989.4e12}) == pytest.approx(1.0)
    assert peaks.least_seconds({"fp32": 494.7e12, "bf16": 989.4e12}) == \
        pytest.approx(2.0)
    assert peaks.least_seconds({"bf16": 1.0}, 3.35e12) == pytest.approx(1.0)

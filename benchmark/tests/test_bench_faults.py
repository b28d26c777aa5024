"""Every cell's comparison fails what it must fail: a run with the timed
path broken underneath (each fault the cell can have), and the control,
the reference one precision step lower in the program's place.  The look
for a card is skipped; the cells run at their tiny sizes on the CPU."""

from __future__ import annotations

import pytest

FAULTS = [
    ("pigan_test_s0", "fault_frozen"), ("pigan_test_s0", "fault_half"),
    ("pigan_test_s1", "fault_frozen"), ("pigan_test_s1", "fault_half"),
    ("nerf_lego_b4096", "fault_frozen"), ("nerf_lego_b4096", "fault_half"),
    ("nerf_lego_view400", "fault_altered"),
]
CONTROLS = ["pigan_test_s0", "pigan_test_s1", "nerf_lego_b4096",
            "nerf_lego_view400"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_path_is_not_correct(run_tiny, cell, fault):
    result = run_tiny(cell, fault)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CONTROLS)
def test_the_control_is_not_correct(run_tiny, cell):
    result = run_tiny(cell, "control")
    assert result["correct"] is False, result["checks"]

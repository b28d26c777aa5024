"""On the card (``python -m pytest benchmark/tests -m card``): each cell
at its own size for a short window comes out correct, and its control
does not."""

from __future__ import annotations

import time

import pytest

from benchmark.harness.registry import Registry

REG = Registry()
CELLS = [w["name"] for w in REG.bench["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    from benchmark.harness.cell import run_cell

    result = run_cell(cell, 2 ** 34 + 1, 2.0, False, time.time())
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell):
    from benchmark.harness.cell import run_cell

    result = run_cell(cell, 2 ** 34 + 2, 0.1, False, time.time(),
                      sut="control")
    assert result["correct"] is False, result["checks"]

"""``correct`` comes out false for each fault a cell can have, planted
under a whole run with the look for a card skipped, at a size a test run
holds; the control (the plain reference in the program's place, its
products in TF32) departs from a sound run there, and fails the cell's
limits at the cell's own size on the card."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import core, faults  # noqa: E402

CELLS = {"protein.cg-tol": 500, "protein.cg-tol-lanes4": 400,
         "3droad.cg-budget": 800, "3droad.ap-budget": 1500}
SPEC = core.load_spec(ROOT)


def fails(plan, readings) -> list:
    return [name for name, limit in plan.traffic["limits"].items()
            if not readings[name] <= limit]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", list(CELLS))
def test_a_planted_fault_is_not_correct(cell, fault):
    plan = core.plan_cell(SPEC, cell)
    with faults.plant(fault):
        out = core.run_cell(plan, 2**31 + 29, 0.0, False, device="cpu",
                            rows=CELLS[cell])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_departs_from_a_sound_run(cell):
    """At a test's size the control's readings are far from a sound run's
    (its limits are set at the cell's size, where it fails them: the card
    test below and PERF.md)."""
    plan = core.plan_cell(SPEC, cell)
    control = core.run_control(plan, 2**31 + 31, "cpu", rows=CELLS[cell])
    sound = core.run_cell(plan, 2**31 + 31, 0.0, False, device="cpu",
                          rows=CELLS[cell])["readings"]
    assert control["grad_gap"] > 10 * sound["grad_gap"], (control, sound)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_is_not_correct_at_the_cells_size(card, cell):
    plan = core.plan_cell(SPEC, cell)
    readings = core.run_control(plan, 2**31 + 37, card)
    assert fails(plan, readings), readings

"""On the card, at each cell's own size: the program within every limit, the control past one.

Run on a machine with the card: ``python3 -m pytest portbench/tests -m cuda``.
Elsewhere these tests skip.
"""

from __future__ import annotations

import pytest
import torch

from portbench.calibrate import readings
from portbench.harness.spec import load_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ens.f32.b2", "conus.bf16"])
def test_full_size_program_within_and_control_past_the_limits(name, card):
    cell = load_cell(name)
    limits = cell.config["limits"]
    program = readings(cell, 3000000031, False, card)
    control = readings(cell, 3000000031, True, card)
    assert all(program[n] <= limit for n, limit in limits.items()), (program, limits)
    assert any(control[n] > limit for n, limit in limits.items()), (control, limits)

"""A whole run, minus the look for a card, at a tiny size on the CPU: sound, broken, the control.

The faults a serving cell can have are an answer altered where it is
produced (here: every nowcast the model's forward returns, in a patch at
its centre, which every tile's interior holds). The control is the plain
reference computed in the configuration's control numerics. At this size it
reads at least three times what the program reads on the same seed; at the
cells' own size it fails the configured limits
(``test_portbench_card.py``, ``portbench/calibrate.py``), which were set
from full-size readings: the widest gap of a few small tiles lies below
that of 48 full tiles, so the bf16 limit is not for this size.
"""

from __future__ import annotations

import pytest
import torch

from portbench.calibrate import readings
from portbench.harness.runner import run_cell
from portbench.tests.tiny import tiny_cell

CELLS = ["ens.f32.b2", "conus.bf16"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = run_cell(tiny_cell(name), 3000000021, 0.5, False, "cpu")
    assert result.failed == 0 and result.rows
    assert result.correct, result.checks


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    from skillful_nowcasting_tpu_torch.dgmr import DGMR

    forward = DGMR.forward

    def altered(self, x, *args, **kwargs):
        out = forward(self, x, *args, **kwargs).clone()
        h, w = out.shape[-2:]
        out[..., h // 2 - 4:h // 2 + 4, w // 2 - 4:w // 2 + 4] += 0.5 * out.abs().max()
        return out

    monkeypatch.setattr(DGMR, "forward", altered)
    result = run_cell(tiny_cell(name), 3000000022, 0.5, False, "cpu")
    assert result.failed == 0 and result.rows
    assert not result.correct, result.checks


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_past_the_program(name):
    cell = tiny_cell(name)
    program = readings(cell, 3000000023, False, torch.device("cpu"))
    control = readings(cell, 3000000023, True, torch.device("cpu"))
    assert all(control[n] >= 3 * program[n] for n in cell.config["limits"]), (program, control)

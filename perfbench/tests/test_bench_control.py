"""The control of the comparison: the f32 reference computed with float8
activations in the program's place reads a wider gap than sound runs of
the program. Here at tiny widths on the CPU, over one file of the
longform cell (a closed loop: the same batches on every machine): the
program (bf16) reads under 0.002, float8 over 0.03, on each seed. At the
cell's own size the readings come from ``perfbench.calibrate`` on the
card; the ``card`` test below runs one seed of it."""

import pytest
import torch

from perfbench import calibrate, spec
from perfbench.tests import tiny

SEEDS = [2 ** 31 + 11, 2 ** 35 + 3, 7, 9]
LIMIT = 0.01


@pytest.fixture(scope="module")
def tiny_readings():
    out = []
    for seed in SEEDS:
        cell = tiny.cell("large-v3.longform.files", limit=LIMIT)
        cell.traffic["check"] = {"files": 1, "windows_per_file": 3}
        out.append(calibrate.readings(cell, seed, 0.1, torch.device("cpu")))
    return out


def test_program_under_limit_at_tiny(tiny_readings):
    assert all(r["failed"] == 0 and r["program"] <= LIMIT
               for r in tiny_readings)


def test_control_over_limit_at_tiny(tiny_readings):
    assert all(r["control"] > LIMIT and r["correct"] for r in tiny_readings)


@pytest.mark.card
def test_control_fails_at_cell_size(card):
    cell = spec.resolve("large-v3.serve.chunks")
    r = calibrate.readings(cell, 2 ** 31 + 101, 6.0, card)
    limit = cell.limits["logit_gap_max"]["limit"]
    assert r["failed"] == 0 and r["program"] <= limit < r["control"]

"""The control on the card: the reference computed in float32 with TF32
matrix products (the precision below the configuration's float32) in the
program's place fails the cell's output check, on three seeds, at the
cell's own size, while the program passes on the same seeds.

Needs an NVIDIA card (marker ``cuda``; skipped without one):

    python -m pytest -p no:cacheprovider -m cuda liobench/tests
"""
from __future__ import annotations

import pytest
import torch

from liobench import check, harness
from liobench.tests.tiny import CELLS

SEEDS = (3001, 3002, 3003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    cell = harness.Cell(workload)
    for seed in SEEDS:
        out = harness.run_cell(workload, seed, 2.0, False, card,
                               control=True)
        assert out["correct"], out["_stderr"]
        ctrl = out["_control"]["numbers"]
        assert not check.verdict(ctrl, cell.limits), ctrl

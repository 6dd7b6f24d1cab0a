"""The output check fails a broken timed path: each cell's run at a tiny
size on the CPU (the plain versions, no look for a card) with the port's
step broken underneath comes out not correct, once for each fault the cell
can have, while the same run unbroken comes out correct.  A cell on one
chip has no exchange between chips to leave out."""
from __future__ import annotations

import pytest
import torch

from fast_lio_tpu_torch import pipeline
from fast_lio_tpu_torch.ops import voxel_grid
from liobench.tests.tiny import CELLS, run


def _frozen_single(self, buf):
    """The step runs, and the filter's state is not written back."""
    *_new, out = pipeline.packed_step(
        self.cfg, self.map_cfg, self.x, self.P, self.map, self.imu_carry,
        self.Q, buf, *self.lm_state)
    return out


def _half_points(pts, mask, *args, **kw):
    """The downsample's means over every other point, the rest left out."""
    keep = torch.arange(mask.shape[-1], device=mask.device) % 2 == 0
    return voxel_grid.voxel_downsample(pts, mask & keep, *args, **kw)


def _altered_pose(step_outputs):
    """``step_outputs`` with the scan's pose moved 1 cm along x (half the
    range noise) where the step produces it."""
    def altered(step):
        x, P, m, carry, lm, out = step_outputs(step)
        shift = torch.zeros_like(out["pose"])
        shift[..., 0] = 1e-2
        return x, P, m, carry, lm, dict(out, pose=out["pose"] + shift)
    return altered


FAULTS = ("state_unchanged", "half_the_points", "pose_altered")


def _break(monkeypatch, fault: str):
    if fault == "state_unchanged":
        monkeypatch.setattr(pipeline.Pipeline, "_packed_step",
                            _frozen_single)
    elif fault == "half_the_points":
        monkeypatch.setattr(pipeline, "voxel_downsample", _half_points)
    else:
        monkeypatch.setattr(pipeline, "step_outputs",
                            _altered_pose(pipeline.step_outputs))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["_stderr"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    _break(monkeypatch, fault)
    out = run(workload)
    assert not out["correct"], out["_stderr"]

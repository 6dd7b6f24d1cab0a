"""A cell at a tiny size, for the tests on the CPU: the plain versions of the
port's kernels, small pads and map, few rays, a small campus, no warm lap,
short windows."""
from __future__ import annotations

import torch

ROUTE = {"a": 14.0, "b": 10.0, "c": 2.0, "lap_scans": 80}
WORLD = {"margin": 10.0, "lot": 10.0, "footprint": [3.0, 6.0],
         "height": [3.0, 8.0], "clear": 3.0, "pole_every": 6.0,
         "pole_offset": 2.5}
TINY = {"config": {"n_points_max": 2048, "n_ds_max": 1024, "map_h_log2": 12},
        "sensor": {"rate": 12000, "rings": 16, "columns": 128},
        "mix": {"warm_laps": 0, "profile_scans": 3, "route": ROUTE,
                "world": WORLD,
                "check": {"start_packets": 8, "chains": 2, "steps": 2}}}
SECONDS = 1.5
CELLS = ("avia.replay", "avia.online", "ouster64.replay")


def run(workload: str, seed: int = 20251018, traced: bool = False,
        **kw) -> dict:
    from liobench import harness
    torch.set_num_threads(2)
    return harness.run_cell(workload, seed, SECONDS, traced, "cpu",
                            overrides=TINY, **kw)

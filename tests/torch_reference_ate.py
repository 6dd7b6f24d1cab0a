"""The JAX package's ATE on chip_smoke.py's two main-path runs.

chip_smoke.py holds the port's ATE on the card against these numbers (plus
1 cm), and imports no JAX itself, so they are computed here once, on a CPU,
and written into chip_smoke.py as constants.  Not a test (pytest does not
collect this file); run it from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py

It runs the JAX pipeline at the presets' full size (a few GB of host memory,
well under a minute) and prints one JSON line per run.
"""
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from fast_lio_tpu import sim as simlib  # noqa: E402
from fast_lio_tpu.config import PRESETS  # noqa: E402
from fast_lio_tpu.pipeline import Pipeline  # noqa: E402

RUNS = {
    # name: (config, sim config) — the same as chip_smoke.py phases 4 and 5
    "avia": (PRESETS["avia"],
             simlib.SimConfig(duration=3.0, n_rings=32, n_azimuth=400)),
    "ouster64": (dataclasses.replace(PRESETS["ouster64"], n_points_max=45056),
                 simlib.SimConfig(duration=2.0, n_rings=64, n_azimuth=688,
                                  elev_min=-22.5, elev_max=22.5)),
}


def run(cfg, sim_cfg):
    data = simlib.generate(sim_cfg)
    pipe = Pipeline(cfg)
    imu_i = 0
    for k in range(len(data.scans)):
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while pipe.spin_once():
            pass
    traj = pipe.get_trajectory()
    return dict(ate_raw_m=simlib.ate_rmse(traj, data),
                ate_aligned_m=simlib.ate_rmse_aligned(traj, data),
                scans=len(traj), health=pipe.health_check())


if __name__ == "__main__":
    for name, (cfg, sim_cfg) in RUNS.items():
        print(json.dumps({"run": name, **run(cfg, sim_cfg)}), flush=True)

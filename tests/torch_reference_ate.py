"""The JAX package's ATE on chip_smoke.py's main-path runs and bag replay.

chip_smoke.py holds the port's ATE on the card against these numbers (plus
1 cm), and imports no JAX itself, so they are computed here once, on a CPU,
and written into chip_smoke.py as constants: the avia and ouster64 runs
(phases 4-6), the ouster64 run in float64 (phase 11; JAX's x64 mode on for
that run only), the bag replay of phase 7 (the avia run written as a
ROS1 bag by the port's ``sim.write_avia_bag``, replayed by the JAX
package's runner with the same flags) and phase ``fleet_batch4`` (the
``avia_batch4`` fleet, ``fast_lio_tpu_torch/tools/scenarios.py``, through
the JAX package's ``BatchPipeline`` for ``BATCH_ROUNDS`` rounds; one ATE per
lane).  Not a test (pytest does not
collect this file); run it from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py [run ...]

It runs the JAX pipeline at the presets' full size (a few GB of host memory,
about a minute a run) and prints one JSON line per run; name runs to run
only those.
"""
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from fast_lio_tpu import cli  # noqa: E402
from fast_lio_tpu import sim as simlib  # noqa: E402
from fast_lio_tpu.config import PRESETS  # noqa: E402
from fast_lio_tpu.pipeline import Pipeline  # noqa: E402
from fast_lio_tpu_torch import sim as port_sim  # noqa: E402

RUNS = {
    # name: (config, sim config) — the same as chip_smoke.py phases 4 and 5
    "avia": (PRESETS["avia"],
             simlib.SimConfig(duration=3.0, n_rings=32, n_azimuth=400)),
    "ouster64": (dataclasses.replace(PRESETS["ouster64"], n_points_max=45056),
                 simlib.SimConfig(duration=2.0, n_rings=64, n_azimuth=688,
                                  elev_min=-22.5, elev_max=22.5)),
}
# chip_smoke.py phase 11: phase 5's run in float64
RUNS["ouster64_f64"] = (
    dataclasses.replace(RUNS["ouster64"][0], compute_dtype="float64"),
    RUNS["ouster64"][1])


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


# chip_smoke.py's fleet_batch4: rounds of the avia_batch4 fleet
BATCH_ROUNDS = 30


def run_fleet_batch4(rounds=BATCH_ROUNDS):
    """The JAX BatchPipeline on avia_batch4 (bench.py's main_batch(4) sim
    runs at the AVIA preset), each round's scans pushed, then spun, until
    ``rounds`` rounds ran; the ATE of each lane."""
    from fast_lio_tpu.batch import BatchPipeline

    datas = [simlib.generate(simlib.SimConfig(duration=10.0, n_rings=16,
                                              n_azimuth=400, seed=s))
             for s in range(4)]
    bp = BatchPipeline(PRESETS["avia"], 4)
    imu_i = [0] * 4
    ran = 0
    for k in range(len(datas[0].scans)):
        for i, d in enumerate(datas):
            stamp = d.scan_stamps[k]
            while (imu_i[i] < len(d.imu_t)
                   and d.imu_t[imu_i[i]] <= stamp + 0.1 + 1e-9):
                bp.push_imu(i, d.imu_t[imu_i[i]], d.imu_acc[imu_i[i]],
                            d.imu_gyr[imu_i[i]])
                imu_i[i] += 1
            bp.push_lidar(i, stamp, d.scans[k], d.scan_pt_times[k])
        while bp.spin_once():
            ran += 1
        if ran >= rounds:
            break
    trajs = [bp.get_trajectory(i) for i in range(4)]
    return dict(rounds=ran, scans=[len(t) for t in trajs],
                ate_m=[(simlib.ate_rmse(t, d), simlib.ate_rmse_aligned(t, d))
                       for t, d in zip(trajs, datas)])


# chip_smoke.py's CLI_BAG_FLAGS
CLI_BAG_FLAGS = ["--preset", "avia", "--point-filter-num", "1",
                 "--blind", "0.3"]


def run_cli_bag(sim_cfg):
    """The JAX runner on the avia run written as a bag."""
    data = simlib.generate(sim_cfg)
    with tempfile.TemporaryDirectory() as tmp:
        bag = Path(tmp) / "avia.bag"
        port_sim.write_avia_bag(bag, port_sim.generate(sim_cfg))
        assert cli.main(CLI_BAG_FLAGS + ["--bag", str(bag), "--out", tmp]) == 0
        rows = np.loadtxt(Path(tmp) / "trajectory_tum.txt", ndmin=2)
    traj = [(r[0], r[1:4], np.array([r[7], r[4], r[5], r[6]])) for r in rows]
    return dict(ate_raw_m=simlib.ate_rmse(traj, data),
                ate_aligned_m=simlib.ate_rmse_aligned(traj, data),
                scans=len(traj))


if __name__ == "__main__":
    names = sys.argv[1:] or [*RUNS, "cli_bag", "fleet_batch4"]
    for name in names:
        if name == "cli_bag":
            out = run_cli_bag(RUNS["avia"][1])
        elif name == "fleet_batch4":
            out = run_fleet_batch4()
        else:
            cfg, sim_cfg = RUNS[name]
            with jax.enable_x64(cfg.compute_dtype == "float64"):
                out = run(cfg, sim_cfg)
        print(json.dumps({"run": name, **out}), flush=True)

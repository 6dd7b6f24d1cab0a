"""The JAX package's ATE on chip_smoke.py's main-path runs and bag replay.

chip_smoke.py holds the port's ATE on the card against these numbers (plus
1 cm), and imports no JAX itself, so they are computed here once, on a CPU,
and written into chip_smoke.py as constants: the avia and ouster64 runs
(phases 4-6), the ouster64 run in float64 (phase 11; JAX's x64 mode on for
that run only), the bag replay of phase 7 (the avia run written as a
ROS1 bag by the port's ``sim.write_avia_bag``, replayed by the JAX
package's runner with the same flags) and phase ``fleet_batch4`` (the
``avia_preset_batch4`` fleet, ``fast_lio_tpu_torch/tools/scenarios.py``,
through the JAX package's ``BatchPipeline`` for ``BATCH_ROUNDS`` rounds; one
ATE per lane), and the runs of phases ``presets`` (``preset_<name>``: horizon,
mid360, velodyne and marsim, ``scenarios.preset_run``) and
``pointcloud2_bags`` (``bag_<name>``: the PointCloud2 bags of
``scenarios.POINTCLOUD2_BAGS`` through the JAX package's runner); these
print the per-scan iterations beside the ATE.  Runs ``bench_<scenario>``
are phase ``bench``'s: the port's runner (``tools/bench.py``) on bench.py's
scenarios cut to ``scenarios.BENCH_DURATION_S``, here the JAX ``Pipeline``
on the same packets (bench.py:270-288), and for ``bench_avia_batch4`` the
JAX ``BatchPipeline`` fed as ``main_batch`` feeds it (bench.py:153-211),
one ATE per lane; each single run prints its health (map drops) too.
Not a test (pytest does not collect this file); run it from the repository
root:

    JAX_PLATFORMS=cpu python tests/torch_reference_ate.py [run ...]

(for example ``... preset_marsim bag_velodyne_no_time``).  With
``--orders N`` first it runs each named packet run (``preset_*``, and
``preset_horizon_room``: horizon in the sim's room) with its points in N orders and prints the ATEs: how far summation order
alone moves the JAX package's own answer.

It runs the JAX pipeline at the presets' full size (a few GB of host memory,
about a minute a run) and prints one JSON line per run; name runs to run
only those.
"""
import contextlib
import dataclasses
import io
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
from fast_lio_tpu import config as jconfig  # noqa: E402
from fast_lio_tpu_torch import sim as port_sim  # noqa: E402
from fast_lio_tpu_torch.tools import scenarios  # noqa: E402

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
# chip_smoke.py phase rescore: phase 4's run with the cached-candidate
# re-search, in float32 and float64
RUNS["avia_rescore"] = (
    dataclasses.replace(RUNS["avia"][0], rescore_research=True),
    RUNS["avia"][1])
RUNS["avia_rescore_f64"] = (
    dataclasses.replace(RUNS["avia_rescore"][0], compute_dtype="float64"),
    RUNS["avia"][1])


def jax_config(cfg):
    """The JAX package's Config of the port's ``cfg`` (the same fields)."""
    return jconfig.Config(**{
        **dataclasses.asdict(cfg),
        "lidar_type": jconfig.LidarType(int(cfg.lidar_type)),
        "time_unit": jconfig.TimeUnit(int(cfg.time_unit))})


def run(cfg, sim_cfg):
    return run_data(cfg, simlib.generate(sim_cfg))


def run_data(cfg, data, with_positions=False):
    """The JAX pipeline on a sim run through the packet API (each scan with
    the IMU samples up to 0.1 s after its stamp); ``with_positions``: each
    estimate's position too."""
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
    out = dict(ate_raw_m=simlib.ate_rmse(traj, data),
               ate_aligned_m=simlib.ate_rmse_aligned(traj, data),
               scans=len(traj), health=pipe.health_check(),
               iterations=[int(d.iterations) for d in pipe.diags])
    if with_positions:
        out["positions"] = [[float(v) for v in p] for _, p, _ in traj]
    return out


# chip_smoke.py phase prune_hall: the prune's hall at full width in float64
# (JAX's x64 mode on for these runs only), with its 32 m cube and with a
# 1000 m cube that never slides; each estimate's position printed
PRUNE_RUNS = {"prune_hall_f64": scenarios.PRUNE_CUBE_SIDE,
              "prune_hall_f64_cube1000": scenarios.NO_PRUNE_CUBE_SIDE}
# chip_smoke.py phase validation: tests/test_validation.py's runs
VALIDATION_RUNS = [f"validation_{n}" for n in scenarios.VALIDATION_RUNS]


def run_prune(cube_side_length):
    cfg, data = scenarios.prune_run(True, cube_side_length)
    with jax.enable_x64(True):
        return run_data(jax_config(cfg), data, with_positions=True)


def preset_data(name):
    """chip_smoke.py phase ``presets``: (config, run) of preset ``name``
    (``scenarios.preset_run``, made by the port's sim)."""
    cfg, _, data = scenarios.preset_run(name)
    return cfg, data


def horizon_room_data(_):
    """The horizon preset on its sim run in the sim's room instead of the
    outdoor hall: where it first ran (see ``--orders``)."""
    cfg, sim_cfg, _ = scenarios.preset_run("horizon")
    return cfg, port_sim.generate(sim_cfg)


def in_order(data, seed):
    """``data`` with each scan's points shuffled by ``seed`` (0: as made),
    the last point kept last (its time gives the packet's end): the sums
    over points then run in another order."""
    if seed == 0:
        return data
    rng = np.random.default_rng(seed)
    perms = [np.append(rng.permutation(len(s) - 1), len(s) - 1)
             for s in data.scans]
    return dataclasses.replace(
        data, scans=[s[p] for s, p in zip(data.scans, perms)],
        scan_pt_times=[t[p] for t, p in zip(data.scan_pt_times, perms)])


def run_pointcloud2_bag(name):
    """chip_smoke.py phase ``pointcloud2_bags``: the bag of
    ``scenarios.POINTCLOUD2_BAGS[name]`` (its preset's sim run cut to
    ``scenarios.BAG_DURATION_S``, written by the port's
    ``sim.write_pointcloud2_bag``) replayed by the JAX package's runner
    with the same flags (the port's run adds ``--profile`` to the marsim
    bag, which changes no estimate)."""
    kind, preset, _ = scenarios.POINTCLOUD2_BAGS[name]
    _, sim_cfg, data = scenarios.preset_run(preset, scenarios.BAG_DURATION_S)
    with tempfile.TemporaryDirectory() as tmp:
        bag = Path(tmp) / f"{name}.bag"
        port_sim.write_pointcloud2_bag(bag, data, kind, sim_cfg)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(scenarios.bag_argv(name, bag, tmp) + ["--health"])
        assert rc == 0
        rows = np.loadtxt(Path(tmp) / "trajectory_tum.txt", ndmin=2)
    traj = [(r[0], r[1:4], np.array([r[7], r[4], r[5], r[6]])) for r in rows]
    health = [json.loads(ln) for ln in printed.getvalue().splitlines()
              if ln.startswith('{"health"')][0]
    return dict(ate_raw_m=simlib.ate_rmse(traj, data),
                ate_aligned_m=simlib.ate_rmse_aligned(traj, data),
                scans=len(traj), **health)


# chip_smoke.py's fleet_batch4: rounds of the avia_preset_batch4 fleet
BATCH_ROUNDS = 30


def run_fleet_batch4(rounds=BATCH_ROUNDS):
    """The JAX BatchPipeline on avia_preset_batch4 (bench.py's main_batch(4) sim
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


def run_bench(name, rescore=False):
    """chip_smoke.py phase ``bench``: bench.py's scenario ``name`` cut to
    ``scenarios.BENCH_DURATION_S``, its packets synced first as bench.py
    syncs them (each scan after the IMU samples up to its stamp plus the
    scan period), then run through the JAX ``Pipeline``; ``rescore``: as
    bench.py runs it with ``FAST_LIO_RESCORE=1``."""
    cfg, data = scenarios.scenario(name, scenarios.BENCH_DURATION_S)
    cfg = dataclasses.replace(cfg, rescore_research=rescore)
    pipe = Pipeline(jax_config(cfg))
    period = float(data.scan_stamps[1] - data.scan_stamps[0])
    imu_i, packets = 0, []
    for k in range(len(data.scans)):
        end = data.scan_stamps[k] + period
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= end + 1e-9:
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        pipe.push_lidar(data.scan_stamps[k], data.scans[k],
                        data.scan_pt_times[k])
        while (pkt := pipe.sync.pop_packet()) is not None:
            packets.append(pkt)
    for pkt in packets:
        pipe.process_packet(pkt)
    traj = pipe.get_trajectory()
    return dict(ate_raw_m=simlib.ate_rmse(traj, data),
                ate_aligned_m=simlib.ate_rmse_aligned(traj, data),
                packets=len(packets), scans=len(traj),
                health=pipe.health_check())


def run_bench_batch(n):
    """chip_smoke.py phase ``bench``'s ``avia_batch<n>``: the JAX
    ``BatchPipeline`` at bench.py's avia config on ``scenarios.batch_runs``
    cut to ``scenarios.BENCH_DURATION_S``, every round fed and spun as
    ``main_batch`` does; the ATE of each lane."""
    from fast_lio_tpu.batch import BatchPipeline

    datas = scenarios.batch_runs(n, scenarios.BENCH_DURATION_S)
    bp = BatchPipeline(jax_config(scenarios.config("avia")), n)
    imu_i = [0] * n
    for k in range(max(len(d.scans) for d in datas)):
        for i, d in enumerate(datas):
            if k >= len(d.scans):
                bp.mark_done(i)
                continue
            stamp = d.scan_stamps[k]
            while (imu_i[i] < len(d.imu_t)
                   and d.imu_t[imu_i[i]] <= stamp + 0.1 + 1e-9):
                bp.push_imu(i, d.imu_t[imu_i[i]], d.imu_acc[imu_i[i]],
                            d.imu_gyr[imu_i[i]])
                imu_i[i] += 1
            bp.push_lidar(i, stamp, d.scans[k], d.scan_pt_times[k])
        while bp.spin_once():
            pass
    trajs = [bp.get_trajectory(i) for i in range(n)]
    return dict(scans=[len(t) for t in trajs],
                ate_m=[(simlib.ate_rmse(t, d), simlib.ate_rmse_aligned(t, d))
                       for t, d in zip(trajs, datas)])


BENCH_RUNS = [f"bench_{n}" for n in (*scenarios.NAMES, "avia_batch4")]
# phase bench's FAST_LIO_RESCORE=1 run of bench.py's avia
BENCH_RESCORE_RUN = "bench_avia_rescore"


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


# the packet runs by name: chip_smoke.py's phase presets (and horizon in
# the room, for --orders)
PACKET_RUNS = {
    **{f"preset_{n}": (preset_data, n)
       for n in ("horizon", "mid360", "velodyne", "marsim")},
    "preset_horizon_room": (horizon_room_data, None),
}
BAG_RUNS = [f"bag_{n}" for n in scenarios.POINTCLOUD2_BAGS]


def run_orders(name, n_orders):
    """The JAX ATE of packet run ``name`` with its points in ``n_orders``
    orders (``in_order``): how far summation order alone moves it."""
    fn, arg = PACKET_RUNS[name]
    cfg, data = fn(arg)
    outs = [run_data(jax_config(cfg), in_order(data, seed))
            for seed in range(n_orders)]
    return {"orders": n_orders,
            **{k: [o[k] for o in outs] for k in ("ate_raw_m", "ate_aligned_m")}}


if __name__ == "__main__":
    args = sys.argv[1:]
    orders = 0
    if args[:1] == ["--orders"]:  # --orders N run ...: ATE over N orders
        orders, args = int(args[1]), args[2:]
    names = args or [*RUNS, "cli_bag", "fleet_batch4",
                     *(n for n in PACKET_RUNS if n != "preset_horizon_room"),
                     *BAG_RUNS, *BENCH_RUNS, BENCH_RESCORE_RUN, *PRUNE_RUNS,
                     *VALIDATION_RUNS]
    for name in names:
        if orders:
            out = run_orders(name, orders)
        elif name in PACKET_RUNS:
            fn, arg = PACKET_RUNS[name]
            cfg, data = fn(arg)
            out = run_data(jax_config(cfg), data)
        elif name in BAG_RUNS:
            out = run_pointcloud2_bag(name[len("bag_"):])
        elif name == BENCH_RESCORE_RUN:
            out = run_bench("avia", rescore=True)
        elif name in PRUNE_RUNS:
            out = run_prune(PRUNE_RUNS[name])
        elif name in VALIDATION_RUNS:
            cfg, data = scenarios.validation_run(name[len("validation_"):])
            out = run_data(jax_config(cfg), data)
        elif name == "bench_avia_batch4":
            out = run_bench_batch(4)
        elif name in BENCH_RUNS:
            out = run_bench(name[len("bench_"):])
        elif name == "cli_bag":
            out = run_cli_bag(RUNS["avia"][1])
        elif name == "fleet_batch4":
            out = run_fleet_batch4()
        else:
            cfg, sim_cfg = RUNS[name]
            with jax.enable_x64(cfg.compute_dtype == "float64"):
                out = run(cfg, sim_cfg)
        print(json.dumps({"run": name, **out}), flush=True)

"""The benchmark scenarios: the sensor envelope of the JAX package's
``bench.py`` (``_scenario``), as configs and simulated runs of the port.

Each is the configuration of the test that proved that envelope point, and
its simulated data (``sim.generate``, seeded, so every run makes the same
scans):

  avia              ~12.8k points a scan indoors, 0.3 m voxels
  ouster64          64 rings, ~44k points a scan indoors, 0.5 m voxels,
                    the sparse preset (cell multiplier 5, wide fallback)
  mid360            100 Hz scans of ~640 points, 0.5 m voxels
  velodyne_outdoor  16 rings in a 90 x 90 m hall, the sparse remedy on
                    (tests/test_sparse_regime.py's outdoor geometry)

and fleets of streams: ``batch_runs(n)`` are bench.py's ``main_batch(n)``
runs (bench.py:169-173): n streams, sim seeds 0 to n - 1, 16 rings x 400
azimuths.  The sim's seed draws only its noise, and these runs have none,
so the n streams carry the same data, as in bench.py.  Two configs run them:

  avia_batchN       ``tools/bench.py``'s fleet (bench.py's ``main_batch``):
                    its avia scenario's config (``config("avia")``,
                    8192-point pad, 4096 downsampled points, 2^13 x 64-slot
                    map), as bench.py:168 has it
  avia_preset_batch4  ``batch_scenario``: four streams at the AVIA
                    preset's full width (32768-point pad, 8192 downsampled
                    points, 2^15 x 64-slot map), ``chip_smoke.py`` phase
                    ``fleet_batch4``

``tools/bench.py`` runs every scenario and fleet as bench.py does (the
port's benchmark, ``ROADMAP.md`` A.18, is to take its cells from there;
``chip_smoke.py`` phase ``bench`` runs it), and ``tools/oracle_ab.py``
through the pipeline and the oracle.

Last, the sensor presets the main-path phases did not run (``preset_run``;
``chip_smoke.py`` phase ``presets``): each preset unchanged, its pads and
map, on a sim run whose rings, field of view and range fit the sensor:

  horizon   Livox Horizon: 81.7 x 25.1 deg ahead, 90 m, 24k points a
            scan, in velodyne_outdoor's hall: in the room its forward view
            finds too few surfaces, and the JAX package's own raw ATE moved
            by 1.2 cm with the order of the points alone
  mid360    Livox MID-360: 360 deg, -7 to 52 deg up, 40 m, 20k points
  velodyne  Velodyne VLP-16: 16 rings over +-15 deg, 0.2 deg columns,
            100 m, spinning clockwise as the driver's time reconstruction
            assumes (``sim.SimConfig.spin``), 28.8k points
  marsim    the MARSIM preset (no deskew, five filter passes): 32 rings,
            30 m (its ``det_range``), 12.8k points
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .. import sim
from ..config import PRESETS, Config, LidarType

NAMES = ("avia", "ouster64", "mid360", "velodyne_outdoor")
PRESET_SIMS = {
    "horizon": sim.SimConfig(n_rings=48, n_azimuth=500, elev_min=-12.55,
                             elev_max=12.55, max_range=90.0, fov_deg=81.7),
    "mid360": sim.SimConfig(n_rings=32, n_azimuth=640, elev_min=-7.0,
                            elev_max=52.0),
    "velodyne": sim.SimConfig(n_rings=16, n_azimuth=1800, elev_min=-15.0,
                              elev_max=15.0, max_range=100.0, spin=-1),
    "marsim": sim.SimConfig(n_rings=32, n_azimuth=400, max_range=30.0),
    # Ouster OS1-64 (1024 x 10 mode): 64 rings over 45 deg, 120 m, 65.5k
    # points; its preset already ran with bench.py's geometry, so only its
    # PointCloud2 bag takes this one
    "ouster64": sim.SimConfig(n_rings=64, n_azimuth=1024, elev_min=-22.5,
                              elev_max=22.5, max_range=120.0),
}
# chip_smoke.py phase ``pointcloud2_bags``: name -> (PointCloud2 layout,
# ``sim.POINTCLOUD2_KINDS``; the preset, whose sim run the bag carries; the
# runner's flags beyond --preset, --bag and the topics); the JAX package's
# runner replays the same bags with the same flags
# (tests/torch_reference_ate.py)
POINTCLOUD2_BAGS = {
    "velodyne": ("velodyne", "velodyne", ["--feature-extract-enable", "1"]),
    "velodyne_no_time": ("velodyne_no_time", "velodyne", []),
    "ouster64": ("ouster", "ouster64", ["--extrinsic-est-en", "0"]),
    "marsim": ("marsim", "marsim", ["--runtime-pos-log"]),
}
BATCH_NAMES = ("avia_preset_batch4",)
DURATION_S = 10.0  # bench.py's runs
# the depth chip_smoke.py cuts its runs to (tests/torch_reference_ate.py
# runs the JAX package on the same data): the presets' runs 2 s, the
# PointCloud2 bags 1.5 s
CUT_DURATION_S = 2.0
BAG_DURATION_S = 1.5
# phase bench: the runner (tools/bench.py) on every scenario and avia_batch4
# (mid360: 300 packets at 100 Hz, 200 of them in its synced pass)
BENCH_DURATION_S = 3.0


def outdoor_world() -> sim.World:
    """The outdoor hall with two pillars (tests/test_sparse_regime.py)."""
    return sim.World(
        room_lo=np.array([-40.0, -20.0, 0.0]),
        room_hi=np.array([50.0, 70.0, 12.0]),
        pillars=(
            (np.array([-10.0, 8.0, 0.0]), np.array([-7.0, 11.0, 12.0])),
            (np.array([12.0, 25.0, 0.0]), np.array([15.5, 28.5, 12.0])),
        ),
    )


def config(name: str) -> Config:
    """bench.py's config of scenario ``name`` (``bench._scenario``)."""
    if name == "avia":
        # Avia-like load: ~12.8k raw points a scan before decimation
        return Config(
            lidar_type=LidarType.AVIA, filter_size_surf=0.3,
            filter_size_map=0.3, n_points_max=8192, n_ds_max=4096,
            n_imu_max=32, map_h_log2=13, det_range=40.0,
            cube_side_length=300.0)
    if name == "ouster64":
        # 64-ring spinning lidar, ~44k rays a scan (an OS1-64 at 10 Hz after
        # the reference's 1-in-3 decimation of 131k)
        return Config(
            lidar_type=LidarType.OUST64, filter_size_surf=0.5,
            filter_size_map=0.5, n_points_max=45056, n_ds_max=8192,
            n_imu_max=32, map_h_log2=13, det_range=100.0,
            cube_side_length=300.0, map_cell_multiplier=5,
            knn_wide_fallback=True)
    if name == "mid360":
        # the high-rate regime: 100 Hz scans of ~640 points
        return Config(
            lidar_type=LidarType.AVIA, filter_size_surf=0.5,
            filter_size_map=0.5, n_points_max=1024, n_ds_max=512,
            n_imu_max=8, map_h_log2=12, det_range=100.0,
            cube_side_length=300.0, map_cell_multiplier=5,
            knn_wide_fallback=True,
            knn_wide_max_queries=128)  # partial-wide at 512-query scans
    if name == "velodyne_outdoor":
        return Config(
            lidar_type=LidarType.VELO16, filter_size_surf=0.5,
            filter_size_map=0.5, n_points_max=8192, n_ds_max=4096,
            n_imu_max=32, map_h_log2=12, det_range=100.0,
            cube_side_length=600.0, map_cell_multiplier=5,
            knn_wide_fallback=True)
    raise ValueError(f"unknown scenario {name!r}: one of {', '.join(NAMES)}")


def scenario(name: str, duration: float = DURATION_S
             ) -> Tuple[Config, sim.SimData]:
    """(config, simulated run) of scenario ``name``; ``duration`` seconds of
    data (``bench.py``'s 10 by default; a shorter run is the same geometry
    with other noise draws, not a prefix)."""
    cfg = config(name)
    if name == "avia":
        sim_cfg = sim.SimConfig(duration=duration, n_rings=16, n_azimuth=400)
    elif name == "ouster64":
        sim_cfg = sim.SimConfig(duration=duration, n_rings=64, n_azimuth=688,
                                elev_min=-22.5, elev_max=22.5)
    elif name == "mid360":
        sim_cfg = sim.SimConfig(duration=duration, scan_period=0.01,
                                n_rings=8, n_azimuth=80, imu_rate=400.0)
    else:  # velodyne_outdoor
        return cfg, outdoor_run(duration)
    return cfg, sim.generate(sim_cfg)


def outdoor_run(duration: float, n_azimuth: int = 320) -> sim.SimData:
    """velodyne_outdoor's simulated run: 16 rings from -22 to 8 degrees,
    ``n_azimuth`` columns, on a 12 m circle in the outdoor hall."""
    return sim.generate(
        sim.SimConfig(duration=duration, n_rings=16, n_azimuth=n_azimuth,
                      elev_min=-22.0, elev_max=8.0, max_range=100.0,
                      range_noise=0.01),
        traj=sim.Trajectory(radius=12.0, omega=0.4), world=outdoor_world())


def preset_run(name: str, duration: float = CUT_DURATION_S
               ) -> Tuple[Config, sim.SimConfig, sim.SimData]:
    """(preset, sim config of ``duration`` seconds, simulated run) of
    sensor preset ``name`` (``PRESET_SIMS``; horizon's in the outdoor
    hall, the others in the sim's room)."""
    if name not in PRESET_SIMS:
        raise ValueError(f"unknown preset run {name!r}: one of "
                         f"{', '.join(PRESET_SIMS)}")
    sim_cfg = dataclasses.replace(PRESET_SIMS[name], duration=duration)
    world = outdoor_world() if name == "horizon" else sim.World()
    return PRESETS[name], sim_cfg, sim.generate(sim_cfg, world=world)


def bag_argv(name: str, bag, out) -> List[str]:
    """The runner's arguments for PointCloud2 bag ``name``
    (``POINTCLOUD2_BAGS``) at ``bag``, writing to ``out``."""
    kind, preset, flags = POINTCLOUD2_BAGS[name]
    return ["--preset", preset, "--bag", str(bag), "--out", str(out),
            "--lid-topic", sim.POINTCLOUD2_TOPICS[kind],
            "--imu-topic", "/imu/data", *flags]


def batch_runs(n: int, duration: float = DURATION_S) -> List[sim.SimData]:
    """bench.py's ``main_batch(n)`` runs (bench.py:169-173): one per
    stream, sim seeds 0 to n - 1, 16 rings x 400 azimuths."""
    return [sim.generate(sim.SimConfig(duration=duration, n_rings=16,
                                       n_azimuth=400, seed=s))
            for s in range(n)]


def batch_scenario(name: str, duration: float = DURATION_S
                   ) -> Tuple[Config, List[sim.SimData]]:
    """(config, one simulated run per stream) of fleet scenario ``name``,
    for ``BatchPipeline(config, len(runs))``."""
    if name == "avia_preset_batch4":
        return PRESETS["avia"], batch_runs(4, duration)
    raise ValueError(
        f"unknown fleet scenario {name!r}: one of {', '.join(BATCH_NAMES)}")


# The local map's prune with removals (``chip_smoke.py`` phase
# ``prune_hall``, tests/test_torch_prune.py): velodyne_outdoor's run with a
# 10 m detection range and a 32 m local-map cube, in float64.  The cube
# (side 32 m, moved when the sensor comes within MOV_THRESHOLD * det_range
# = 15 m of a face) slides as the sensor circles the hall, and the prune
# frees every map point it leaves; with a 1000 m cube it never slides.
PRUNE_DET_RANGE = 10.0
PRUNE_CUBE_SIDE = 32.0
NO_PRUNE_CUBE_SIDE = 1000.0
# the CPU test's cut: 128 columns, 2048/1024-point pads
PRUNE_SMALL = dict(n_azimuth=128, n_points_max=2048, n_ds_max=1024)


def prune_run(full: bool = True, cube_side_length: float = PRUNE_CUBE_SIDE,
              duration: float = BENCH_DURATION_S
              ) -> Tuple[Config, sim.SimData]:
    """(config, simulated run) of the prune's hall: velodyne_outdoor's
    config and run (``full``: its 320 columns and 8192/4096-point pads;
    else ``PRUNE_SMALL``) with ``PRUNE_DET_RANGE`` and the local-map cube
    ``cube_side_length``, in float64."""
    cfg = dataclasses.replace(config("velodyne_outdoor"),
                              det_range=PRUNE_DET_RANGE,
                              cube_side_length=cube_side_length,
                              compute_dtype="float64")
    n_azimuth = 320
    if not full:
        cfg = dataclasses.replace(
            cfg, n_points_max=PRUNE_SMALL["n_points_max"],
            n_ds_max=PRUNE_SMALL["n_ds_max"])
        n_azimuth = PRUNE_SMALL["n_azimuth"]
    return cfg, outdoor_run(duration, n_azimuth)


# tests/test_validation.py's runs (``chip_smoke.py`` phase ``validation``):
# its ``_small_cfg`` and its two sims, the 60 s stream with random-walking
# IMU biases and the 20 s planar-degenerate corridor
VALIDATION_RUNS = ("bias_walk", "corridor")
VALIDATION_BIAS_G = (0.002, -0.001, 0.0015)  # the walk's start, rad/s


def validation_config(**kw) -> Config:
    """tests/test_validation.py's ``_small_cfg``."""
    base = dict(
        lidar_type=LidarType.AVIA, filter_size_surf=0.3, filter_size_map=0.3,
        n_points_max=2048, n_ds_max=1024, n_imu_max=32, map_h_log2=13,
        det_range=40.0, cube_side_length=300.0)
    base.update(kw)
    return Config(**base)


def validation_run(name: str) -> Tuple[Config, sim.SimData]:
    """(config, simulated run) of tests/test_validation.py's run ``name``:
    ``bias_walk`` (its test (a)) or ``corridor`` (test (b))."""
    if name == "bias_walk":
        return validation_config(), sim.generate(sim.SimConfig(
            duration=60.0, n_rings=8, n_azimuth=150,
            imu_gyr_bias=VALIDATION_BIAS_G, imu_acc_bias=(0.05, -0.03, 0.02),
            imu_gyr_bias_walk=2e-4, imu_acc_bias_walk=2e-3,
            imu_acc_noise=0.01, imu_gyr_noise=0.001, range_noise=0.01))
    if name == "corridor":
        world = sim.World(room_lo=np.array([-40.0, -2.0, 0.0]),
                          room_hi=np.array([120.0, 2.0, 3.0]), pillars=())
        traj = sim.Trajectory(radius=200.0, omega=0.0025, z_amp=0.2)
        return validation_config(det_range=15.0), sim.generate(
            sim.SimConfig(duration=20.0, n_rings=8, n_azimuth=150,
                          max_range=15.0, range_noise=0.01,
                          imu_acc_noise=0.01, imu_gyr_noise=0.001),
            traj=traj, world=world)
    raise ValueError(f"unknown validation run {name!r}: one of "
                     f"{', '.join(VALIDATION_RUNS)}")

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

and one fleet of streams (``batch_scenario``):

  avia_batch4       bench.py's ``main_batch(4)`` (bench.py:153-232): four
                    streams, sim seeds 0-3, 16 rings x 400 azimuths, at
                    the AVIA preset's full width (32768-point pad, 8192
                    downsampled points, 2^15 x 64-slot map); bench.py ran
                    its avia scenario's config.  The sim's seed draws only
                    its noise, and this run has none, so the four streams
                    carry the same data, as in bench.py.

``tools/oracle_ab.py`` runs them through the pipeline and the oracle; the
port's benchmark (``ROADMAP.md`` A.18) is to take its cells from here, and
``chip_smoke.py`` phase ``fleet_batch4`` runs ``avia_batch4``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import sim
from ..config import PRESETS, Config, LidarType

NAMES = ("avia", "ouster64", "mid360", "velodyne_outdoor")
BATCH_NAMES = ("avia_batch4",)
DURATION_S = 10.0  # bench.py's runs


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


def scenario(name: str, duration: float = DURATION_S
             ) -> Tuple[Config, sim.SimData]:
    """(config, simulated run) of scenario ``name``; ``duration`` seconds of
    data (``bench.py``'s 10 by default; a shorter run is the same geometry
    with other noise draws, not a prefix)."""
    if name == "avia":
        # Avia-like load: ~12.8k raw points a scan before decimation
        cfg = Config(
            lidar_type=LidarType.AVIA, filter_size_surf=0.3,
            filter_size_map=0.3, n_points_max=8192, n_ds_max=4096,
            n_imu_max=32, map_h_log2=13, det_range=40.0,
            cube_side_length=300.0)
        return cfg, sim.generate(
            sim.SimConfig(duration=duration, n_rings=16, n_azimuth=400))
    if name == "ouster64":
        # 64-ring spinning lidar, ~44k rays a scan (an OS1-64 at 10 Hz after
        # the reference's 1-in-3 decimation of 131k)
        cfg = Config(
            lidar_type=LidarType.OUST64, filter_size_surf=0.5,
            filter_size_map=0.5, n_points_max=45056, n_ds_max=8192,
            n_imu_max=32, map_h_log2=13, det_range=100.0,
            cube_side_length=300.0, map_cell_multiplier=5,
            knn_wide_fallback=True)
        return cfg, sim.generate(
            sim.SimConfig(duration=duration, n_rings=64, n_azimuth=688,
                          elev_min=-22.5, elev_max=22.5))
    if name == "mid360":
        # the high-rate regime: 100 Hz scans of ~640 points
        cfg = Config(
            lidar_type=LidarType.AVIA, filter_size_surf=0.5,
            filter_size_map=0.5, n_points_max=1024, n_ds_max=512,
            n_imu_max=8, map_h_log2=12, det_range=100.0,
            cube_side_length=300.0, map_cell_multiplier=5,
            knn_wide_fallback=True,
            knn_wide_max_queries=128)  # partial-wide at 512-query scans
        return cfg, sim.generate(
            sim.SimConfig(duration=duration, scan_period=0.01, n_rings=8,
                          n_azimuth=80, imu_rate=400.0))
    if name == "velodyne_outdoor":
        cfg = Config(
            lidar_type=LidarType.VELO16, filter_size_surf=0.5,
            filter_size_map=0.5, n_points_max=8192, n_ds_max=4096,
            n_imu_max=32, map_h_log2=12, det_range=100.0,
            cube_side_length=600.0, map_cell_multiplier=5,
            knn_wide_fallback=True)
        return cfg, sim.generate(
            sim.SimConfig(duration=duration, n_rings=16, n_azimuth=320,
                          elev_min=-22.0, elev_max=8.0, max_range=100.0,
                          range_noise=0.01),
            traj=sim.Trajectory(radius=12.0, omega=0.4),
            world=outdoor_world())
    raise ValueError(f"unknown scenario {name!r}: one of {', '.join(NAMES)}")


def batch_scenario(name: str, duration: float = DURATION_S
                   ) -> Tuple[Config, List[sim.SimData]]:
    """(config, one simulated run per stream) of fleet scenario ``name``,
    for ``BatchPipeline(config, len(runs))``."""
    if name == "avia_batch4":
        return PRESETS["avia"], [
            sim.generate(sim.SimConfig(duration=duration, n_rings=16,
                                       n_azimuth=400, seed=s))
            for s in range(4)]
    raise ValueError(
        f"unknown fleet scenario {name!r}: one of {', '.join(BATCH_NAMES)}")

"""Configuration system: one dataclass, per-sensor presets.

A verbatim copy of ``fast_lio_tpu/config.py`` (importing that module would
pull in JAX through ``fast_lio_tpu/__init__.py``); tests/test_torch_config.py
holds the two equal field by field and preset by preset.

Mirrors the reference's full parameter surface (YAML files in
reference/config/*.yaml loaded through ~30 nh.param reads,
laserMapping.cpp:761-793), as plain dataclasses with the same keys and
defaults, plus the runtime knobs (padding sizes, dtypes, map capacity).
"""
from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Optional, Tuple

import numpy as np


class LidarType(IntEnum):  # preprocess.h:17
    AVIA = 1
    VELO16 = 2
    OUST64 = 3
    MARSIM = 4


class TimeUnit(IntEnum):  # preprocess.h:18
    SEC = 0
    MS = 1
    US = 2
    NS = 3

    @property
    def to_ms(self) -> float:  # preprocess.cpp:52-69
        return {0: 1e3, 1: 1.0, 2: 1e-3, 3: 1e-6}[int(self)]


@dataclasses.dataclass
class Config:
    # --- preprocess (config/*.yaml "preprocess:") ---
    lidar_type: LidarType = LidarType.AVIA
    n_scans: int = 6
    blind: float = 0.01  # blind-zone radius, m
    point_filter_num: int = 2  # keep 1-in-N points
    time_unit: TimeUnit = TimeUnit.US
    scan_rate: int = 10
    feature_extract_enable: bool = False  # default off in every launch file

    # --- common ---
    time_sync_en: bool = False
    time_offset_lidar_to_imu: float = 0.0

    # --- mapping (config/*.yaml "mapping:") ---
    max_iteration: int = 3  # launch default (mapping_avia.launch:10)
    filter_size_surf: float = 0.5
    filter_size_map: float = 0.5
    cube_side_length: float = 1000.0
    det_range: float = 300.0  # Avia 450, mid360 100 ...
    fov_degree: float = 90.0
    gyr_cov: float = 0.1
    acc_cov: float = 0.1
    b_gyr_cov: float = 0.0001
    b_acc_cov: float = 0.0001
    extrinsic_est_en: bool = True
    extrinsic_T: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    extrinsic_R: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)

    # --- filter constants (laserMapping.cpp:63-66,826) ---
    laser_point_cov: float = 0.001
    epsi: Tuple[float, ...] = 0.001  # scalar, or a per-component 23-vector
    # (the reference passes epsi[23] to init_dyn_share, laserMapping.cpp:826-828
    # — all 0.001 in practice; a tuple here sets per-DOF thresholds)
    init_time: float = 0.1  # EKF grace period, s
    max_ini_count: int = 10  # IMU static-init sample threshold

    # --- publish/save toggles (parity with config/*.yaml) ---
    path_en: bool = True
    scan_publish_en: bool = True
    dense_publish_en: bool = True
    scan_bodyframe_pub_en: bool = True
    pcd_save_en: bool = False
    pcd_save_interval: int = -1
    runtime_pos_log: bool = False
    stage_timing: bool = False  # opt-in honest timing: force a real device
    # sync per scan so StepDiag.total_time is true per-scan latency (costs
    # pipelining), and let the CSV writer populate the search/incremental/
    # delete columns from slope-method device timers (utils.stage_timing)
    # instead of zeros.  Off = async dispatch (fast), total_time is labeled
    # dispatch-only.

    # --- TPU runtime ---
    knn_backend: str = "auto"  # "auto" | "xla" (synonyms) | "grouped".
    # "auto"/"xla": the per-query CUDA kNN kernel (csrc/knn.cu), the
    # default.  "grouped": the region-grouped CUDA kernel
    # (csrc/knn_grouped.cu; queries sorted by region key, groups of <= 8
    # share their rows).  Both compute hash_map.knn_search; on CPU tensors
    # each runs its plain PyTorch version.
    knn_wide_fallback: bool = False  # when the 2x2x2 search leaves queries
    # unsaturated (< 5 neighbors or 5th NN beyond the covered radius), re-run
    # those scans' search over the centered 3x3x3 region (coverage radius =
    # cell_size) — closes the sparse-regime gap toward the reference's
    # sqrt(5) m acceptance gate (laserMapping.cpp:671) at ~3.4x search cost,
    # paid only on scans that need it.
    map_cell_multiplier: int = 4  # storage cell = N x map voxel; 5 with
    # knn_wide_fallback gives full sqrt(5)-gate coverage at 0.5 m voxels.
    knn_wide_max_queries: int = 2048  # partial-wide budget: with at most
    # this many unsaturated queries only they take the wide 3x3x3 rows
    # (EXACT — saturated narrow results are provably exact; the JAX package
    # re-searches just them, compacted); with more, every row does.  0: every
    # row whenever one query is unsaturated (pipeline.wide_fallback).
    rescore_research: bool = False  # converged-iteration re-searches re-rank
    # the scan's cached candidate block instead of re-gathering the map:
    # ~exact (pose moves mm between iterates) and saves 1-2 gathers/scan.
    # Off by default for reference-faithful association.
    n_points_max: int = 32768  # raw scan pad (post-decimation)
    pad_buckets: Tuple[int, ...] = ()  # optional scan-size buckets, e.g.
    # (4096, 8192, 16384, 32768): each scan runs at the smallest pad that
    # fits (one XLA compile per bucket, persistent-cached); empty = single
    # pad n_points_max.  Oversized scans are truncated WITH accounting
    # (pipeline.health_check()['truncated_points']), never silently.
    n_ds_max: int = 8192  # downsampled block pad (the filter's N)
    n_imu_max: int = 64  # IMU samples per scan pad
    map_h_log2: int = 15  # 32768 buckets
    map_bucket_slots: Optional[int] = None  # None = derived: one full cell's
    # worth of downsample voxels per bucket (cell_multiplier^3 rounded up to
    # a multiple of 64) — 64 at the default multiplier 4, 128 at the sparse
    # presets' 5.  Capacity = 2^map_h_log2 * slots (~2.1M points default).
    compute_dtype: str = "float32"

    @property
    def extrinsic_R_mat(self) -> np.ndarray:
        return np.asarray(self.extrinsic_R, dtype=np.float64).reshape(3, 3)

    @property
    def extrinsic_T_vec(self) -> np.ndarray:
        return np.asarray(self.extrinsic_T, dtype=np.float64)


# ---------------------------------------------------------------------------
# Per-sensor presets mirroring the reference's config/*.yaml
# ---------------------------------------------------------------------------

AVIA = Config(
    lidar_type=LidarType.AVIA,
    n_scans=6,
    blind=4.0,
    point_filter_num=3,
    time_unit=TimeUnit.US,
    det_range=450.0,
    fov_degree=70.4,
    extrinsic_T=(0.04165, 0.02326, -0.0284),
)

HORIZON = Config(
    lidar_type=LidarType.AVIA,
    n_scans=6,
    blind=4.0,
    point_filter_num=3,
    det_range=260.0,
    fov_degree=100.0,
    extrinsic_T=(0.05512, 0.02226, -0.0297),
)

# The spinning-lidar / outdoor presets enable the sparse-regime remedy:
# storage cell = 5 x map voxel + wide 3x3x3 fallback => guaranteed kNN
# coverage 2.5 m >= the reference's sqrt(5) m acceptance gate
# (laserMapping.cpp:671), closing the far-field association gap the
# fixed-radius hash search otherwise has vs the unbounded ikd-Tree search
# (tests/test_sparse_regime.py proves recall 1.0 vs the brute-force gate).

MID360 = Config(
    lidar_type=LidarType.AVIA,
    n_scans=4,
    blind=0.5,
    point_filter_num=3,
    det_range=100.0,
    fov_degree=360.0,
    extrinsic_T=(-0.011, -0.02329, 0.04412),
    map_cell_multiplier=5,
    knn_wide_fallback=True,
)

OUSTER64 = Config(
    lidar_type=LidarType.OUST64,
    n_scans=64,
    blind=4.0,
    point_filter_num=3,
    time_unit=TimeUnit.NS,
    det_range=150.0,
    fov_degree=180.0,
    extrinsic_T=(0.0, 0.0, 0.0),
    map_cell_multiplier=5,
    knn_wide_fallback=True,
)

VELODYNE = Config(
    lidar_type=LidarType.VELO16,
    n_scans=16,
    blind=2.0,
    point_filter_num=2,
    time_unit=TimeUnit.MS,
    scan_rate=10,
    det_range=100.0,
    fov_degree=180.0,
    filter_size_surf=0.5,
    filter_size_map=0.5,
    map_cell_multiplier=5,
    knn_wide_fallback=True,
)

MARSIM = Config(
    lidar_type=LidarType.MARSIM,
    n_scans=1,
    blind=0.1,
    point_filter_num=1,
    det_range=30.0,
    fov_degree=180.0,
    max_iteration=4,
)

PRESETS = {
    "avia": AVIA,
    "horizon": HORIZON,
    "mid360": MID360,
    "ouster64": OUSTER64,
    "velodyne": VELODYNE,
    "marsim": MARSIM,
}

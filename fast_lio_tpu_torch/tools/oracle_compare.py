"""The port's pipeline against the f64 oracle (``oracle.py``) in both modes,
on the oracle-trace stream: a noisy, IMU-biased sim run, the stream of
``tests/test_oracle_trace.py``.  Prints per-scan position and rotation
deltas.

Run from the repository root (CUDA by default):

    python3 -m fast_lio_tpu_torch.tools.oracle_compare [n_scans]
        [--device cpu] [--dtype float64]

The port of the JAX package's ``tools/oracle_compare.py``, with its lines;
``--dtype`` sets the pipeline's ``compute_dtype`` (the oracle is always
f64).  The oracle's brute-force kNN makes each packet cost seconds as the
map grows, so ``tests/test_torch_oracle.py`` and ``chip_smoke.py``'s oracle
phase, which use the functions here, keep the stream's first packets
(``packets_of(..., limit)``).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from .. import sim
from ..config import Config, LidarType
from ..oracle import OracleLIO, quat_to_mat
from ..pipeline import Pipeline, ScanPacket, SyncBuffer

N_SCANS = 25  # tests/test_oracle_trace.py's stream
MODES = {"intended": dict(quirks=False, plane_fit="orthogonal"),
         "reference": dict(quirks=True)}


def make_cfg(dtype: str = "float32") -> Config:
    """The oracle trace's configuration (tests/test_oracle_trace.py)."""
    return Config(
        lidar_type=LidarType.AVIA, filter_size_surf=0.3, filter_size_map=0.3,
        n_points_max=8192, n_ds_max=4096, n_imu_max=32, map_h_log2=13,
        det_range=40.0, cube_side_length=300.0, knn_backend="xla",
        compute_dtype=dtype)


def make_data(n_scans: int = N_SCANS) -> sim.SimData:
    """The oracle trace's sim run: range noise, IMU noise and biases."""
    return sim.generate(sim.SimConfig(
        duration=n_scans * 0.1 + 0.3, n_rings=16, n_azimuth=400,
        range_noise=0.02, imu_acc_noise=0.02, imu_gyr_noise=0.002,
        imu_acc_bias=(0.05, -0.03, 0.02), imu_gyr_bias=(0.004, -0.002, 0.003),
    ))


def packets_of(data: sim.SimData, cfg: Config,
               limit: Optional[int] = None) -> List[ScanPacket]:
    """The synced packets of a sim run (the pipeline's ``SyncBuffer``), the
    first ``limit`` of them."""
    sync = SyncBuffer(cfg)
    out = []
    imu_i = 0
    for k in range(len(data.scans)):
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            sync.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        sync.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while (p := sync.pop_packet()) is not None:
            out.append(p)
    return out[:limit]


def run_pipeline(cfg: Config, pkts, device=None):
    """The port's trajectory on the packets (CUDA unless ``device``)."""
    pipe = Pipeline(cfg, device=device)
    for p in pkts:
        pipe.process_packet(p)
    return pipe.get_trajectory()


def run_oracle(cfg: Config, pkts, **mode):
    """The oracle's trajectory on the packets, in ``mode``."""
    orc = OracleLIO(cfg, **mode)
    for p in pkts:
        orc.process_packet(p)
    return orc.trajectory


def deltas(traj_a, traj_b):
    """Per-scan position (m) and rotation (rad) deltas over the last scans
    both trajectories hold (their stamps must agree)."""
    n = min(len(traj_a), len(traj_b))
    dp, dr = [], []
    for (t1, p1, q1), (t2, p2, q2) in zip(traj_a[-n:], traj_b[-n:]):
        if abs(t1 - t2) >= 1e-9:
            raise ValueError(f"stamps differ: {t1} and {t2}")
        dp.append(np.linalg.norm(np.asarray(p1) - np.asarray(p2)))
        R1 = quat_to_mat(np.asarray(q1) / np.linalg.norm(q1))
        R2 = quat_to_mat(np.asarray(q2) / np.linalg.norm(q2))
        c = (np.trace(R1.T @ R2) - 1) / 2
        dr.append(np.arccos(np.clip(c, -1, 1)))
    return np.asarray(dp), np.asarray(dr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_scans", nargs="?", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline (default cuda)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"),
                    help="the pipeline's compute_dtype")
    args = ap.parse_args(argv)
    cfg = make_cfg(args.dtype)
    data = make_data(args.n_scans)
    pkts = packets_of(data, cfg)

    t0 = time.time()
    traj_pipe = run_pipeline(cfg, pkts, args.device)
    print(f"pipeline: {len(traj_pipe)} poses in {time.time()-t0:.1f}s "
          f"ate={sim.ate_rmse(traj_pipe, data)*100:.2f}cm", flush=True)

    results = {}
    for name, mode in MODES.items():
        t0 = time.time()
        results[name] = run_oracle(cfg, pkts, **mode)
        ate = sim.ate_rmse(results[name], data)
        print(f"oracle[{name}]: {len(results[name])} poses in "
              f"{time.time()-t0:.1f}s ate={ate*100:.2f}cm", flush=True)

    for name, traj_o in results.items():
        dp, dr = deltas(traj_pipe, traj_o)
        print(f"pipe vs oracle[{name}]: pos max {dp.max()*1000:.3f} mm "
              f"p50 {np.median(dp)*1000:.3f} mm | rot max {dr.max()*1e3:.3f} "
              f"mrad p50 {np.median(dr)*1e3:.3f} mrad")
    return 0


if __name__ == "__main__":
    sys.exit(main())

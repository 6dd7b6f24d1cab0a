"""Each stage of the per-scan step (``pipeline.lio_step``) alone, at a
benchmark scenario's shapes: its device time per call and its host enqueue
time per call.

Run from the repository root (CUDA by default):

    python3 -m fast_lio_tpu_torch.tools.profile_stages [scenario]
        [--reps 20] [--device cpu]

scenario: avia (default), ouster64, mid360 or velodyne_outdoor
(``tools/scenarios.py``).  The port of the JAX package's
``tools/profile_stages.py``, with its inputs (a map of 120000 uniform
points, scan-like data at the scenario's pads, ``numpy.random.default_rng
(0)``) and its rows; the kNN stage is ``pipeline.make_knn_fn``, so it runs
the configured backend with the wide fallback.  Per row
(``microbench_device.per_call``): on a card ``device_ms``
(``torch.profiler``'s device activities per call: what the
stage costs the card once host dispatch is gone) and ``enqueue_ms`` (host
clock around one call, no synchronize inside: for the update, whose exit
test reads the device once an iteration, the wait is in it); on the CPU
``host_ms`` only.  The last row sums the stages a scan runs once (imu,
downsample, update, insert): the per-scan device floor.  Prints the JAX
tool's lines, then one JSON line with every row.  ``tools/profile_scan.py``
profiles whole scans.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import imu as imu_mod
from .. import state as st
from ..filter import ekf, process
from ..map import hash_map as hm
from ..ops import measurement as meas
from ..ops.voxel_grid import voxel_downsample
from ..pipeline import make_knn_fn
from . import scenarios
from .microbench_device import card, per_call, print_row

TOTAL = "{}-bound total (imu+ds+update+insert)"  # device, or host (CPU)


MAP_POINTS = 120000


def stages(cfg, device: torch.device) -> dict:
    """name -> (call, counted in the total), on the JAX tool's inputs."""
    map_cfg = hm.make_config(
        voxel_size=cfg.filter_size_map, h_log2=cfg.map_h_log2,
        bucket_slots=cfg.map_bucket_slots,
        cell_multiplier=cfg.map_cell_multiplier)
    rng = np.random.default_rng(0)
    dt = torch.float32
    f32 = dict(dtype=dt, device=device)

    def t(a):
        return torch.tensor(np.asarray(a), **f32)

    mpts = t(rng.uniform(-20, 20, size=(MAP_POINTS, 3)).astype(np.float32))
    on = torch.ones(MAP_POINTS, dtype=torch.bool, device=device)
    m = hm.insert(hm.make_map(map_cfg, dt, device), map_cfg, mpts, on, ~on)
    N_RAW, N_DS, N_IMU = cfg.n_points_max, cfg.n_ds_max, cfg.n_imu_max
    pts_raw = t(rng.uniform(-15, 15, size=(N_RAW, 3)))
    pt_mask = torch.arange(N_RAW, device=device) < int(N_RAW * 0.78)
    pt_time = t(np.sort(rng.uniform(0, 0.1, N_RAW)))
    pts_ds = t(rng.uniform(-15, 15, size=(N_DS, 3)))
    ds_mask = torch.arange(N_DS, device=device) < int(N_DS * 0.63)
    x0 = st.identity_state(dt, device)
    P0 = torch.eye(st.DOF, **f32)
    Q = process.process_noise_cov(0.1, 0.1, 1e-4, 1e-4, dt, device)
    carry0 = imu_mod.init_imu_carry(dt, device)
    imu_t = t(np.linspace(0, 0.1, N_IMU))
    imu_acc = t(rng.normal(0, 0.1, (N_IMU, 3)) + [0, 0, 9.81])
    imu_gyr = t(rng.normal(0, 0.05, (N_IMU, 3)))
    imu_mask = torch.ones(N_IMU, dtype=torch.bool, device=device)
    scalars = t([1.0, -0.005, 0.1])  # acc_scale, last end, scan end
    knn_fn = make_knn_fn(cfg, map_cfg, m)
    cache0 = meas.empty_cache(N_DS, dt, device)
    m_ins = hm.Map(m.packed.clone(), m.dropped.clone())  # insert's own map
    no_nbrs = torch.zeros((N_DS, 5, 3), **f32)
    no_found = torch.zeros((N_DS, 5), dtype=torch.bool, device=device)
    box = (t([-150.0, -150, -150]), t([150.0, 150, 150]))

    def h_fn(x_i, converge, cache):
        h_x, h, sel, cache, valid, _pw = meas.compute_measurement(
            x_i, pts_ds, ds_mask, knn_fn, cache, converge, True)
        return ekf.MeasOut(h_x, h, sel, valid, cache)

    def insert():
        add, dsf = hm.insert_decisions(pts_ds, ds_mask, no_nbrs, no_found,
                                       True, cfg.filter_size_map)
        hm.insert(m_ins, map_cfg, pts_ds, add, dsf)

    return {
        f"imu propagate+deskew ({N_IMU} knots, {N_RAW} pts)": (
            lambda: imu_mod.propagate_and_deskew(
                x0, P0, Q, imu_t, imu_acc, imu_gyr, imu_mask, scalars[0],
                scalars[1], scalars[2], carry0, pts_raw, pt_time,
                deskew=True), True),
        f"voxel downsample ({N_RAW} -> {N_DS})": (
            lambda: voxel_downsample(pts_raw, pt_mask, cfg.filter_size_surf,
                                     N_DS,
                                     coord_bound=cfg.det_range * 1.25 + 5.0),
            True),
        f"knn search ({N_DS} q, configured backend)": (
            lambda: knn_fn(pts_ds, ds_mask), False),
        "measurement (knn+fit+H, 1 eval)": (
            lambda: meas.compute_measurement(x0, pts_ds, ds_mask, knn_fn,
                                             cache0, True, True), False),
        f"full iterated update ({cfg.max_iteration} iters)": (
            lambda: ekf.update_iterated(x0, P0, h_fn, cache0,
                                        cfg.laser_point_cov,
                                        cfg.max_iteration, cfg.epsi), True),
        f"map insert ({N_DS})": (insert, True),
        "map prune (gated, rarely fires)": (
            lambda: hm.prune_outside(m, *box), False),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", nargs="?", default="avia",
                    choices=scenarios.NAMES)
    ap.add_argument("--reps", type=int, default=20,
                    help="calls per profiler window and host-clock median")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("profile_stages: no CUDA device; nothing measured "
              "(--device cpu times the host)", file=sys.stderr)
        return 1
    cfg, _data = scenarios.scenario(args.scenario, duration=0.2)
    print(f"scenario={args.scenario}  pads: raw={cfg.n_points_max} "
          f"ds={cfg.n_ds_max} imu={cfg.n_imu_max}  "
          f"knn wide_fallback={cfg.knn_wide_fallback}", flush=True)
    rows, total = {}, 0.0
    key = "device_ms" if device.type == "cuda" else "host_ms"
    for name, (fn, counted) in stages(cfg, device).items():
        rows[name] = per_call(fn, args.reps, device)
        print_row(name, rows[name], 46)
        if counted:
            total += rows[name][key] or 0.0
    label = TOTAL.format("device" if device.type == "cuda" else "host")
    print(f"{label:46s} {total:8.3f} ms", flush=True)
    out: dict = {"tool": "profile_stages", "scenario": args.scenario,
                 "device": device.type, "reps": args.reps, "rows": rows,
                 "total_" + key: total}
    if device.type == "cuda":
        out["card"] = card()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

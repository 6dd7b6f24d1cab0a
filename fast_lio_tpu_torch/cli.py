"""Command-line runner — the ``fastlio_mapping`` node analog.

Port of ``fast_lio_tpu/cli.py`` with the same flags and outputs:

    python -m fast_lio_tpu_torch.cli --preset avia --bag data.bag \\
        --lid-topic /livox/lidar --imu-topic /livox/imu --out out/

    python -m fast_lio_tpu_torch.cli --sim --duration 10 --out out/

``--platform`` names the torch device: ``cuda`` by default; without a
CUDA device the runner exits non-zero unless ``--platform cpu`` is given
(the CPU runs the kernels' plain PyTorch versions).  ``--profile`` turns
the port's tracer on (``tracing``) and writes a ``torch.profiler`` trace to
``<out>/trace/trace.json``, with the tracer's spans as ``fast_lio.*`` ranges
and its stage stamps' kernels, and the tracer's dump to
``<out>/trace/program_trace.json``.

Outputs (matching the reference's observability surface):
  out/trajectory_tum.txt       TUM-format trajectory (t x y z qx qy qz qw)
  out/pos_log.txt              full-state dump (dump_lio_state_to_log layout)
  out/fast_lio_time_log.csv    timing CSV (reference schema)
  out/scans[_<i>].pcd          accumulated DENSE world scans (--pcd-save,
                               chunked by --pcd-save-interval)
  out/map.pcd                  live voxel map export (--map-save)
  out/checkpoint.npz           estimator+map checkpoint (--checkpoint)
  out/stream<i>/trajectory_tum.txt   per-stream trajectories (several --bag)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch


def build_parser():
    p = argparse.ArgumentParser(prog="fast_lio_tpu_torch")
    p.add_argument("--preset", default="avia",
                   help="sensor preset: avia|horizon|mid360|ouster64|velodyne|marsim")
    p.add_argument("--bag", action="append",
                   help="ROS1 bag to replay; repeat the flag to replay "
                        "SEVERAL bags as lockstep streams "
                        "(fast_lio_tpu_torch.batch fleet mode)")
    p.add_argument("--lid-topic", default="/livox/lidar")
    p.add_argument("--imu-topic", default="/livox/imu")
    p.add_argument("--sim", action="store_true", help="run the synthetic world")
    p.add_argument("--duration", type=float, default=10.0, help="sim duration")
    p.add_argument("--max-scans", type=int, default=0)
    p.add_argument("--out", default="out")
    p.add_argument("--pcd-save", action="store_true",
                   help="accumulate every dense world-frame scan into "
                        "scans.pcd (the reference's pcd_save_en)")
    p.add_argument("--pcd-save-interval", type=int, default=None,
                   help="flush the accumulation to scans_<i>.pcd every N "
                        "scans (reference pcd_save_interval; default -1 = "
                        "one scans.pcd at exit)")
    p.add_argument("--map-save", action="store_true",
                   help="export the live voxel map to map.pcd (the "
                        "/Laser_map surface; distinct from --pcd-save)")
    p.add_argument("--checkpoint", action="store_true")
    p.add_argument("--resume", help="checkpoint.npz to resume from")
    p.add_argument("--platform", default=None,
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--runtime-pos-log", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace and the tracer's "
                        "spans and stage stamps into <out>/trace")
    p.add_argument("--health", action="store_true",
                   help="print an estimator health report at the end")
    p.add_argument("--stage-timing", action="store_true",
                   help="honest timing CSV: sync per scan (total time = real "
                        "per-scan latency) and fill the search/incremental/"
                        "delete columns from device stage timers")
    # the reference's most-used parameter overrides
    p.add_argument("--filter-size-surf", type=float)
    p.add_argument("--filter-size-map", type=float)
    p.add_argument("--max-iteration", type=int)
    p.add_argument("--point-filter-num", type=int)
    p.add_argument("--blind", type=float)
    p.add_argument("--extrinsic-est-en", type=int)
    p.add_argument("--feature-extract-enable", type=int)
    return p


def _write_tum(path: Path, traj) -> None:
    with open(path, "w") as f:
        for t, p, q in traj:  # q is wxyz -> TUM wants xyzw
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def _start_profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, out: Path, device: torch.device) -> None:
    from . import tracing

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    (out / "trace").mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace" / "trace.json"))
    (out / "trace" / "program_trace.json").write_text(
        json.dumps(tracing.dump(), default=str))
    tracing.disable()


def _run_fleet(args, cfg, device, out: Path, prof, t0: float) -> int:
    """Several --bag: one lockstep BatchPipeline over all bags."""
    from .batch import BatchPipeline
    from .io.rosbag import BagReader
    from .preprocess.drivers import decode

    bp = BatchPipeline(cfg, len(args.bag), device=device)
    bags = [BagReader(b) for b in args.bag]
    try:
        readers = [b.messages({args.lid_topic, args.imu_topic}) for b in bags]
        live = [True] * len(readers)
        counts = [0] * len(readers)
        while any(live):
            for i, r in enumerate(readers):
                if not live[i]:
                    continue
                try:
                    topic, _mt, _stamp, msg = next(r)
                except StopIteration:
                    live[i] = False
                    bp.mark_done(i)
                    continue
                if topic == args.imu_topic:
                    bp.push_imu(i, msg["stamp"], msg["linear_acceleration"],
                                msg["angular_velocity"])
                else:
                    scan = decode(msg, cfg)
                    bp.push_lidar(i, msg["stamp"], scan.pts,
                                  scan.time_offset_s, scan.intensity)
                    counts[i] += 1
                    if args.max_scans and counts[i] >= args.max_scans:
                        live[i] = False
                        bp.mark_done(i)
            while bp.spin_once():
                pass
        while bp.spin_once():
            pass
    finally:
        for b in bags:
            b.close()
    if prof is not None:
        _stop_profiler(prof, out, device)
    for i in range(len(args.bag)):
        if bp.imu_need_init[i]:
            print(f"WARNING: stream {i} ({args.bag[i]}) never completed "
                  "IMU static init — check --imu-topic and the bag's "
                  "IMU message count", file=sys.stderr)
        elif not bp.trajectory[i]:
            print(f"WARNING: stream {i} ({args.bag[i]}) produced no "
                  "estimates", file=sys.stderr)
    for i in range(len(args.bag)):
        d = out / f"stream{i}"
        d.mkdir(parents=True, exist_ok=True)
        _write_tum(d / "trajectory_tum.txt", bp.get_trajectory(i))
    total = sum(len(t) for t in bp.trajectory)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "streams": len(args.bag), "scans_total": total,
        "wall_s": round(wall, 3),
        "aggregate_scans_per_sec": round(total / max(wall, 1e-9), 2),
        "out": str(out),
    }))
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)

    device = torch.device(args.platform or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("fast_lio_tpu_torch: no CUDA device; pass --platform cpu to "
              "run the plain CPU path", file=sys.stderr)
        return 1

    from .config import PRESETS
    from .math import so3
    from .pipeline import Pipeline
    from .utils import checkpoint as ckpt
    from .utils.timing import ScanTiming, StateLog, TimingLog

    cfg = PRESETS[args.preset]
    overrides = {
        "filter_size_surf": args.filter_size_surf,
        "filter_size_map": args.filter_size_map,
        "max_iteration": args.max_iteration,
        "point_filter_num": args.point_filter_num,
        "blind": args.blind,
    }
    overrides = {k: v for k, v in overrides.items() if v is not None}
    if args.extrinsic_est_en is not None:
        overrides["extrinsic_est_en"] = bool(args.extrinsic_est_en)
    if args.feature_extract_enable is not None:
        overrides["feature_extract_enable"] = bool(args.feature_extract_enable)
    if args.runtime_pos_log:
        overrides["runtime_pos_log"] = True
    if args.stage_timing:
        overrides["stage_timing"] = True
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    fleet = bool(args.bag) and len(args.bag) > 1
    if fleet:
        # single-stream-only surfaces: reject explicitly rather than
        # silently ignore (each binds to ONE Pipeline's state)
        blocked = [name for name, on in [
            ("--resume", args.resume), ("--pcd-save", args.pcd_save),
            ("--map-save", args.map_save), ("--checkpoint", args.checkpoint),
            ("--health", args.health), ("--stage-timing", args.stage_timing),
            ("--runtime-pos-log", args.runtime_pos_log),
        ] if on]
        if blocked:
            print(f"fleet mode (multiple --bag) does not support: "
                  f"{', '.join(blocked)}", file=sys.stderr)
            return 2

    pipe = None
    if not fleet:
        pipe = Pipeline(cfg, device=device)
        if args.resume:
            ckpt.load_pipeline(args.resume, pipe)
            print(f"resumed from {args.resume}")

    prof = None
    if args.profile:  # before the first capture, so its graph holds stamps
        from . import tracing
        tracing.enable(device)
        prof = _start_profiler(device)

    accum = None
    if args.pcd_save:
        interval = (args.pcd_save_interval if args.pcd_save_interval
                    is not None else cfg.pcd_save_interval)
        accum = ckpt.PcdAccumulator(out, save_interval=interval)
    seen = [0]

    def on_scan(pipe):
        # accumulate only for packets that actually produced an estimate
        # (IMU-init packets return early and leave no new diag)
        if accum is not None and len(pipe.diags) > seen[0]:
            seen[0] = len(pipe.diags)
            accum.add(*pipe.last_cloud_world_dense())

    t0 = time.perf_counter()
    if args.sim:
        from . import sim as simlib

        data = simlib.generate(simlib.SimConfig(duration=args.duration))
        imu_i = 0
        n = len(data.scans) if not args.max_scans else min(
            args.max_scans, len(data.scans))
        for k in range(n):
            stamp = data.scan_stamps[k]
            end = stamp + 0.1
            while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= end + 1e-9:
                pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                              data.imu_gyr[imu_i])
                imu_i += 1
            pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
            while pipe.spin_once():
                on_scan(pipe)
        ate = simlib.ate_rmse(pipe.get_trajectory(), data)
        print(f"sim ATE RMSE: {ate * 100:.2f} cm")
    elif fleet:
        return _run_fleet(args, cfg, device, out, prof, t0)
    elif args.bag:
        from .io.rosbag import replay_into_pipeline

        n = replay_into_pipeline(
            args.bag[0], pipe, args.lid_topic, args.imu_topic,
            max_scans=args.max_scans or None, on_scan=on_scan,
        )
        print(f"replayed {n} scans from {args.bag[0]}")
    else:
        print("nothing to do: pass --bag or --sim", file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    if prof is not None:
        _stop_profiler(prof, out, device)
    if args.health:
        print(json.dumps({"health": pipe.health_check()}))

    # ---- outputs ----
    traj = pipe.get_trajectory()
    _write_tum(out / "trajectory_tum.txt", traj)

    # stage columns: zeros when timers are off; with --stage-timing they
    # carry run-level device timings at the run's shapes, and total_time is
    # real synced per-scan latency (see utils.stage_timing)
    stage = {"search": 0.0, "incremental": 0.0, "delete": 0.0}
    if cfg.stage_timing and pipe.diags:
        stage = pipe.measure_stage_times()
        print(f"stage timers ({device.type}): {json.dumps(stage)}")
    tlog = TimingLog()
    for i, d in enumerate(pipe.diags):
        tlog.append(ScanTiming(
            time_stamp=traj[i][0] if i < len(traj) else 0.0,
            total_time=d.total_time,
            scan_point_size=int(d.n_raw),
            search_time=stage["search"],
            incremental_time=stage["incremental"],
            delete_time=stage["delete"],
            tree_size_end=int(d.map_size),
            add_point_size=int(d.n_down),
            preprocess_time=d.preprocess_time,
            n_eff=int(d.n_effective),
        ))
    tlog.write_csv(out / "fast_lio_time_log.csv")

    if args.runtime_pos_log and pipe.state_log:
        slog = StateLog(out / "pos_log.txt")
        t0s = pipe.state_log[0][0]
        for t, x in pipe.state_log:
            xh = [v.detach().cpu().numpy() for v in x]
            xh = type(x)(*xh)
            rot_log = so3.so3_log(torch.from_numpy(xh.rot)).numpy()
            slog.append(t - t0s, rot_log, xh.pos, xh.vel, xh.bg, xh.ba,
                        xh.grav)
        slog.close()

    if accum is not None:
        written = accum.finish()
        print(f"pcd: {accum.total_points} dense points in "
              f"{len(written)} file(s): {written}")
    if args.map_save:
        # the live voxel map (/Laser_map surface, laserMapping.cpp:944-947)
        from .map.hash_map import flatten

        ckpt.save_pcd(out / "map.pcd", flatten(pipe.map))

    if args.checkpoint:
        ckpt.save_pipeline(out / "checkpoint.npz", pipe)

    n_scans = len(traj)
    summary = {
        "scans": n_scans,
        "wall_s": round(wall, 3),
        "scans_per_sec": round(n_scans / max(wall, 1e-9), 2),
        "device": str(device),
        "out": str(out),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What the sharded path costs, and how its throughput moves with the ranks.

The port of the JAX package's ``tools/bench_scaling.py``.  Run from the
repository root:

    python3 -m fast_lio_tpu_torch.tools.bench_scaling            # card
    python3 -m fast_lio_tpu_torch.tools.bench_scaling --eager    # card
    python3 -m fast_lio_tpu_torch.tools.bench_scaling --ablate   # card
    python3 -m fast_lio_tpu_torch.tools.bench_scaling --trend    # cards
    python3 -m fast_lio_tpu_torch.tools.bench_scaling --trend --device cpu

* default, the intercept: the same scans through the unsharded pipeline and
  through one NCCL rank of the sharded one, in turns, both captured (one
  CUDA graph per pad bucket, as JAX jits both); the ratio of their scans/s
  is what the sharded path costs at n = 1.  ``--eager`` runs the eager
  pair too (``graphs=False``), in the same rounds, and reports both
  intercepts.
* ``--ablate``: its split: five variants in interleaved rounds (unsharded;
  sharded; sharded without the kNN merge; without the sums of the
  reductions and map size; without both; ``sharding.ABLATE_*``, exact at
  one rank), each pass on a fresh pipeline (a captured step keeps the flags
  it was recorded with), best of the rounds.
* ``--trend``: the JAX tool's TREND question on cards: NCCL ranks 1, 2
  and 4 (``--ranks``), one card each, captured (``--eager``: eager too, in
  the same rounds), with the unsharded pipeline's passes beside them in
  the one-rank launch; best of 2 rounds per rank.  Asking for more ranks
  than there are cards raises.  ``--device cpu``: gloo ranks on the CPU at
  the JAX tool's small shapes, and the unsharded pipeline, all eager, one
  round; the ranks share the host's cores, so that trend shows the
  collectives' cost on one host, not a speed-up.

Every run is a worker process (``parallel.launch``), the unsharded one too,
so both sides run under the same conditions.  Scans are synced packets,
taken from the sync buffer before the clock starts; the first ``N_WARM``
are not timed (IMU init, map seeding, the capture); the clock stops after a
read of the covariance, which waits for the device.  Prints one JSON line
per pass, then a summary line, and on the card its name and power limit.

``drive`` runs a preset through the packet API on one rank and returns its
figures; ``drive_modes`` runs it captured and eager on the same scans.
``chip_smoke.py``'s sharded phases call them.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import config, sim
from ..kernels import counts, graph_if, segment_sum
from ..kernels import knn as knn_kernel
from ..parallel import check_cards, launch
from ..parallel import sharding
from ..pipeline import Pipeline

N_WARM = 5
VARIANTS = {  # name -> (sharded, ABLATE_NO_MERGE, ABLATE_NO_PSUM)
    "unsharded": (False, False, False),
    "sharded_full": (True, False, False),
    "sharded_no_merge": (True, True, False),
    "sharded_no_psum": (True, False, True),
    "sharded_no_both": (True, True, True),
}


def build(small: bool, scans: int = None):
    """(Config, SimConfig): the JAX tool's shapes (``small``: its CPU-trend
    shapes), with ``scans`` timed scans after the warm-up if given."""
    kw = dict(lidar_type=config.LidarType.AVIA, filter_size_surf=0.3,
              filter_size_map=0.3, n_points_max=8192, n_ds_max=4096,
              n_imu_max=32, map_h_log2=13, det_range=40.0,
              cube_side_length=300.0)
    if small:
        kw.update(n_points_max=2048, n_ds_max=1024, map_h_log2=12)
    duration = 4.0 if small else 10.0
    if scans is not None:
        duration = 0.1 * (N_WARM + scans + 1) + 0.05
    return config.Config(**kw), sim.SimConfig(
        duration=duration, n_rings=16, n_azimuth=100 if small else 400)


def packets(pipe: Pipeline, data: sim.SimData) -> list:
    """Every synced packet of a sim run, from ``pipe``'s sync buffer."""
    imu_i, out = 0, []
    for k in range(len(data.scans)):
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while (p := pipe.sync.pop_packet()) is not None:
            out.append(p)
    return out


def pass_name(variant: str, graphs) -> str:
    """A pass's name: the variant, with ``_eager`` when it runs eagerly."""
    return variant if graphs is None else f"{variant}_eager"


def timed_pass(group, variant: str, cfg, pkts, graphs=None) -> float:
    """Scans/s of one pass over ``pkts`` on a fresh pipeline (the warm-up
    untimed), with the variant's ablation flags set for the whole pass.
    ``graphs``: ``Pipeline``'s (None: its default, captured on a card over
    NCCL and alone; False: eager)."""
    sharded, no_merge, no_psum = VARIANTS[variant]
    sharding.ABLATE_NO_MERGE, sharding.ABLATE_NO_PSUM = no_merge, no_psum
    try:
        pipe = (Pipeline(cfg, group=group, graphs=graphs) if sharded
                else Pipeline(cfg, device=group.device, graphs=graphs))
        for p in pkts[:N_WARM]:
            pipe.process_packet(p)
        float(pipe.P[0, 0])
        t0 = time.perf_counter()
        for p in pkts[N_WARM:]:
            pipe.process_packet(p)
        float(pipe.P[0, 0])  # waits for the device
        return (len(pkts) - N_WARM) / (time.perf_counter() - t0)
    finally:
        sharding.ABLATE_NO_MERGE = sharding.ABLATE_NO_PSUM = False


def rounds(group, passes, n_rounds: int, small: bool, scans: int) -> list:
    """``n_rounds`` rounds of each pass (``(variant, graphs)``), the order
    reversed every other round; [(round, pass name, scans/s)]."""
    cfg, sim_cfg = build(small, scans)
    pkts = packets(Pipeline(cfg, device=group.device), sim.generate(sim_cfg))
    out = []
    for r in range(n_rounds):
        for v, g in (passes if r % 2 == 0 else passes[::-1]):
            out.append((r, pass_name(v, g), timed_pass(group, v, cfg, pkts, g)))
    return out


def run_scans(pipe, data, n: int, lo: int = 0):
    """Generator: each next() pushes scan k of ``data`` (with the IMU
    samples up to its end that no earlier scan took) into ``pipe`` and runs
    it, for ``lo`` <= k < ``n``; from ``lo`` > 0 it continues a run that
    stopped after scan ``lo - 1`` (a resumed checkpoint)."""
    imu_i = 0 if lo == 0 else int(np.searchsorted(
        data.imu_t, data.scan_stamps[lo - 1] + 0.1 + 1e-9, side="right"))
    for k in range(lo, n):
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while pipe.spin_once():
            pass
        yield k


def drive_data(group, cfg, data, n_scans=None, warm: int = N_WARM,
               graphs=None, sync_free: bool = False, profile_scans: int = 0):
    """``drive`` on generated ``data``, through ``Pipeline(cfg,
    group=group, graphs=graphs)``; returns (the pipeline, the figures),
    with the graphs' stats per pad bucket (None when eager), the kNN
    launches per R (``launches`` float32, ``launches_f64``) and the
    downsample's ``segment_sum`` launches by the scalar's bits.

    The first ``warm`` scans run one by one, the device synced after each.
    The rest do too, unless ``sync_free``: then they run in one window
    under ``torch.cuda.set_sync_debug_mode("error")`` (any host sync
    raises), drained at its end (scans/s: the window's), but for the last
    ``profile_scans``, which run under ``torch.profiler``
    (``profile_scan.profile_window``: device busy, activities, syncs and
    NCCL kernels a scan; and ``executed``, what the step ran there:
    ``profile_scan.executed_per_scan``).  The kNN launches are counted as
    run: a gated graph's IF nodes count theirs on the device
    (``kernels.counts.settle``)."""
    pipe = Pipeline(cfg, group=group, graphs=graphs)
    n = len(data.scans) if n_scans is None else n_scans
    counts.settle()  # a gated graph's launches, counted on the device
    for c in (knn_kernel.launches, knn_kernel.launches_f64,
              graph_if.launches, graph_if.while_launches,
              segment_sum.launches):
        for r in c:
            c[r] = 0
    cuda = pipe.device.type == "cuda"
    push = run_scans(pipe, data, n)
    times = []
    for _ in range(warm if sync_free else n):
        t0 = time.perf_counter()
        next(push)
        if cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    figures = {}
    if not sync_free:
        scans_per_s = (n - warm) / sum(times[warm:])
    else:
        n_window = n - warm - profile_scans
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            for _ in range(n_window):
                next(push)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        scans_per_s = n_window / (time.perf_counter() - t0)
        if profile_scans:
            from .profile_scan import executed_per_scan, profile_window

            counts.settle()
            before = counts.snapshot()
            figures["profile"] = profile_window(lambda: next(push),
                                                profile_scans)
            counts.settle()
            figures["executed"] = executed_per_scan(
                cfg, pipe.graphs is not None,
                [int(d.iterations) for d in pipe.diags[-profile_scans:]],
                counts.since(before))
    counts.settle()
    launches = dict(knn_kernel.launches)
    launches_f64 = dict(knn_kernel.launches_f64)
    traj = pipe.get_trajectory()
    stats = pipe.graphs.stats() if pipe.graphs is not None else None
    figures.update(
        rank=group.rank, world=group.world, transport=group.transport,
        graphs=stats, pad_buckets=pipe.pad_buckets,
        stamps=[t for t, _, _ in traj],
        positions=np.stack([p for _, p, _ in traj]),
        ate_raw_m=sim.ate_rmse(traj, data),
        ate_aligned_m=sim.ate_rmse_aligned(traj, data),
        health=pipe.health_check(), launches=launches,
        launches_f64=launches_f64, scans_per_s=scans_per_s,
        if_nodes_run=graph_if.launches[0],
        while_launches=dict(graph_if.while_launches),
        segment_sum_launches=dict(segment_sum.launches),
        iterations=[int(d.iterations) for d in pipe.diags],
        iterations_mean=float(np.mean([int(d.iterations) for d in pipe.diags])),
        n_effective_last=int(pipe.diags[-1].n_effective))
    return pipe, figures


def drive(group, cfg, sim_cfg, n_scans: int = None, warm: int = N_WARM) -> dict:
    """One rank of a sharded run: the first ``n_scans`` scans of the sim run
    through ``Pipeline(cfg, group=group)``'s packet API, the device synced
    after each; returns the rank's trajectory, ATE, health report (global
    map size and drops), kNN kernel launches of the run (counted from 0
    just before it, per R, replays included), the graphs' stats, scans/s
    after ``warm`` scans and the group's transport."""
    return drive_data(group, cfg, sim.generate(sim_cfg), n_scans, warm)[1]


def drive_modes(group, cfg, sim_cfg, n_scans: int, warm: int,
                profile_scans: int) -> dict:
    """``drive`` of the same scans eager (``graphs=False``) and then
    captured (the default on NCCL ranks), each ``sync_free`` with the last
    ``profile_scans`` profiled on a card (``drive_data``); then the captured
    pipeline's ``measure_stage_times`` (a collective, after its launches
    are read) and ``pose_covariance``.  Returns {"captured": ..., "eager":
    ..., "stage_times": ..., "pose_covariance": ...}.  On CPU ranks (a
    rehearsal) both runs are eager and synced, with no profile."""
    data = sim.generate(sim_cfg)
    card = group.device.type == "cuda"
    profile_scans = profile_scans if card else 0
    eager = drive_data(group, cfg, data, n_scans, warm, False, card,
                   profile_scans)[1]
    pipe, captured = drive_data(group, cfg, data, n_scans, warm, None, card,
                            profile_scans)
    stage_times = pipe.measure_stage_times()
    return dict(captured=captured, eager=eager, stage_times=stage_times,
                pose_covariance=pipe.pose_covariance())


def _print(obj) -> None:
    print(json.dumps(obj), flush=True)


def trend(ranks, eager: bool, scans) -> int:
    """``--trend`` on cards: one launch of n NCCL ranks per rank count,
    each running the sharded passes (captured, and eager with ``eager``),
    the one-rank launch also the unsharded ones; one JSON line per pass and
    rank count, the slowest rank's best scans/s first."""
    from .microbench_knn import card

    modes = [None, False] if eager else [None]
    for n in ranks:  # refused before anything runs
        check_cards(n, "nccl")
    for n in ranks:
        variants = ["sharded_full"] if n > 1 else ["unsharded", "sharded_full"]
        passes = [(v, g) for g in modes for v in variants]
        res = launch(rounds, n, args=(passes, 2, False, scans),
                     backend="nccl")
        for v, g in passes:
            name = pass_name(v, g)
            best = [max(sps for _, w, sps in r if w == name) for r in res]
            _print({"mode": name, "n_ranks": n, "platform": "gpu",
                    "transport": "nccl", "scans_per_sec": min(best),
                    "scans_per_sec_by_rank": best,
                    "device": torch.cuda.get_device_name(0)})
    print(card(), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--ablate", action="store_true")
    mode.add_argument("--trend", action="store_true")
    ap.add_argument("--eager", action="store_true",
                    help="the eager pair too (graphs=False), in the same "
                         "rounds")
    ap.add_argument("--ranks", default="1,2,4",
                    help="--trend: the rank counts, comma-separated")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="--trend: cpu runs gloo ranks on the host")
    ap.add_argument("--scans", type=int, default=None,
                    help="timed scans per pass (default: the whole sim run "
                         "after the warm-up)")
    args = ap.parse_args(argv)
    if args.device == "cpu" and not args.trend:
        ap.error("--device cpu goes with --trend")

    if args.trend and args.device == "cpu":
        ranks = [int(n) for n in args.ranks.split(",")]
        runs = [("unsharded", 1)] + [("sharded_full", n) for n in ranks]
        for variant, n in runs:
            res = launch(rounds, n, args=([(variant, None)], 1, True,
                                          args.scans),
                         backend="gloo", device="cpu")
            _print({"mode": variant, "n_ranks": n, "platform": "cpu",
                    "transport": "gloo", "scans_per_sec": res[0][0][2]})
        return 0

    if not torch.cuda.is_available():
        print("bench_scaling: no CUDA device; nothing measured (--trend "
              "--device cpu runs on the CPU)", file=sys.stderr)
        return 1
    if args.trend:
        return trend([int(n) for n in args.ranks.split(",")], args.eager,
                     args.scans)
    from .microbench_knn import card

    variants = list(VARIANTS) if args.ablate else ["unsharded", "sharded_full"]
    modes = [None, False] if args.eager else [None]
    passes = [(v, g) for g in modes for v in variants]
    n_rounds = 3 if args.ablate else 2
    res = launch(rounds, 1, args=(passes, n_rounds, False, args.scans),
                 backend="nccl")[0]
    best = {}
    for r, name, sps in res:
        best[name] = max(best.get(name, 0.0), sps)
        _print({"round": r, "mode": name, "n_ranks": 1, "scans_per_sec": sps})
    intercepts = {}
    for g in modes:
        base = best[pass_name("unsharded", g)]
        for v in variants[1:]:
            name = pass_name(v, g)
            intercepts[f"intercept_{name[len('sharded_'):]}"] = base / best[name]
    _print({"best_of_rounds": best,
            "median": {pass_name(v, g): statistics.median(
                s for _, w, s in res if w == pass_name(v, g))
                for v, g in passes},
            **intercepts,
            "device": torch.cuda.get_device_name(0), "transport": "nccl"})
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

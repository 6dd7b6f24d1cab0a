"""What the sharded path costs, and how its throughput moves with the ranks.

The port of the JAX package's ``tools/bench_scaling.py``.  Run from the
repository root:

    python3 -m fast_lio_tpu_torch.tools.bench_scaling            # card
    python3 -m fast_lio_tpu_torch.tools.bench_scaling --ablate   # card
    python3 -m fast_lio_tpu_torch.tools.bench_scaling --trend    # CPU

* default, the intercept: the same scans through the unsharded pipeline and
  through one NCCL rank of the sharded one, in turns, both eager (the
  sharded step is not captured in a CUDA graph); the ratio of their
  scans/s is what the sharded path costs at n = 1.
* ``--ablate``: its split: five variants in interleaved rounds (unsharded;
  sharded; sharded without the kNN merge; without the sums of the
  reductions and map size; without both; ``sharding.ABLATE_*``, exact at
  one rank), each pass on a fresh pipeline, best of the rounds.
* ``--trend``: gloo ranks 1, 2 and 4 (``--ranks``) on the CPU at the JAX
  tool's small shapes, and the unsharded pipeline.  Ranks share the host's
  cores, so the trend shows the collectives' cost on one host; a speed-up
  across cards needs cards.

Every run is a worker process (``parallel.launch``), the unsharded one too,
so both sides run under the same conditions.  Scans are synced packets,
taken from the sync buffer before the clock starts; the first ``N_WARM``
are not timed (IMU init, map seeding); the clock stops after a read of the
covariance, which waits for the device.  Prints one JSON line per pass,
then a summary line, and on the card its name and power limit.

``drive`` runs a preset through the packet API on one rank and returns its
figures; ``chip_smoke.py``'s sharded phases call it.
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
from ..kernels import knn as knn_kernel
from ..parallel import launch
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


def timed_pass(group, variant: str, cfg, pkts) -> float:
    """Scans/s of one pass over ``pkts`` on a fresh pipeline (the warm-up
    untimed), with the variant's ablation flags set for the whole pass."""
    sharded, no_merge, no_psum = VARIANTS[variant]
    sharding.ABLATE_NO_MERGE, sharding.ABLATE_NO_PSUM = no_merge, no_psum
    try:
        # the sharded step runs eagerly, so the unsharded one does too: the
        # ratio is then the cost of the sharded path, not of the graph
        pipe = (Pipeline(cfg, group=group) if sharded
                else Pipeline(cfg, device=group.device, graphs=False))
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


def rounds(group, variants, n_rounds: int, small: bool, scans: int) -> list:
    """``n_rounds`` rounds of one pass per variant, the order reversed
    every other round; [(round, variant, scans/s)]."""
    cfg, sim_cfg = build(small, scans)
    pkts = packets(Pipeline(cfg, device=group.device), sim.generate(sim_cfg))
    out = []
    for r in range(n_rounds):
        for v in (variants if r % 2 == 0 else variants[::-1]):
            out.append((r, v, timed_pass(group, v, cfg, pkts)))
    return out


def drive(group, cfg, sim_cfg, n_scans: int = None, warm: int = N_WARM) -> dict:
    """One rank of a sharded run: the first ``n_scans`` scans of the sim run
    through ``Pipeline(cfg, group=group)``'s packet API, the device synced
    after each; returns the rank's trajectory, ATE, health report (global
    map size and drops), kNN kernel launches of the run (counted from 0
    just before it, per R), scans/s after ``warm`` scans and the group's
    transport."""
    data = sim.generate(sim_cfg)
    pipe = Pipeline(cfg, group=group)
    n = len(data.scans) if n_scans is None else n_scans
    for r in knn_kernel.launches:
        knn_kernel.launches[r] = 0
    imu_i, times = 0, []
    for k in range(n):
        t0 = time.perf_counter()
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while pipe.spin_once():
            pass
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(knn_kernel.launches)
    traj = pipe.get_trajectory()
    steady = times[warm:]
    return dict(
        rank=group.rank, world=group.world, transport=group.transport,
        stamps=[t for t, _, _ in traj],
        positions=np.stack([p for _, p, _ in traj]),
        ate_raw_m=sim.ate_rmse(traj, data),
        ate_aligned_m=sim.ate_rmse_aligned(traj, data),
        health=pipe.health_check(), launches=launches,
        scans_per_s=len(steady) / sum(steady),
        iterations_mean=float(np.mean([int(d.iterations) for d in pipe.diags])),
        n_effective_last=int(pipe.diags[-1].n_effective))


def _print(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--ablate", action="store_true")
    mode.add_argument("--trend", action="store_true")
    ap.add_argument("--ranks", default="1,2,4",
                    help="--trend: the rank counts, comma-separated")
    ap.add_argument("--scans", type=int, default=None,
                    help="timed scans per pass (default: the whole sim run "
                         "after the warm-up)")
    args = ap.parse_args(argv)

    if args.trend:
        ranks = [int(n) for n in args.ranks.split(",")]
        runs = [("unsharded", 1)] + [("sharded_full", n) for n in ranks]
        for variant, n in runs:
            res = launch(rounds, n, args=([variant], 1, True, args.scans),
                         backend="gloo", device="cpu")
            _print({"mode": variant, "n_ranks": n, "platform": "cpu",
                    "transport": "gloo", "scans_per_sec": res[0][0][2]})
        return 0

    if not torch.cuda.is_available():
        print("bench_scaling: no CUDA device; nothing measured (--trend "
              "runs on the CPU)", file=sys.stderr)
        return 1
    from .microbench_knn import card

    variants = list(VARIANTS) if args.ablate else ["unsharded", "sharded_full"]
    n_rounds = 3 if args.ablate else 2
    res = launch(rounds, 1, args=(variants, n_rounds, False, args.scans),
                 backend="nccl")[0]
    best = {}
    for r, v, sps in res:
        best[v] = max(best.get(v, 0.0), sps)
        _print({"round": r, "mode": v, "n_ranks": 1, "scans_per_sec": sps})
    base = best["unsharded"]
    _print({"best_of_rounds": best,
            "median": {v: statistics.median(s for _, w, s in res if w == v)
                       for v in variants},
            **{f"intercept_{v[len('sharded_'):]}": base / best[v]
               for v in variants if v != "unsharded"},
            "device": torch.cuda.get_device_name(0), "transport": "nccl"})
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's benchmark runner: the JAX package's ``bench.py`` harness
(``main`` and ``main_batch``, bench.py:153-440) on the card.

Run from the repository root:

    python3 -m fast_lio_tpu_torch.tools.bench [scenario] [--duration S]
                                              [--device cuda|cpu]

Prints ONE JSON line, bench.py's: ``{"metric": "lio_scan_rate", "value",
"unit", "vs_baseline", "extra"}``, ``vs_baseline`` the scans/s over 100 (the
reference's > 100 Hz claim).  The scenarios are bench.py's
(``tools/scenarios.py``): avia (the default), ouster64, mid360,
velodyne_outdoor, and ``avia_batchN``, N streams through one
``BatchPipeline`` (aggregate scans/s; lockstep fleet replay).  The data is
``--duration`` seconds of sim (bench.py's 10 by default).  It runs on the
card; without one it exits 1 unless ``--device cpu`` asks for the plain
versions on the CPU.

The measurement is bench.py's (bench.py:19-33):

* the packets are synced before any clock starts (bench.py:270-288);
* the first ``N_WARM`` packets (IMU init, the map seeded, the capture of
  the step's CUDA graph, a cold build of the kNN kernels) run and the card
  is drained (``torch.cuda.synchronize``) before the clock starts;
  ``warm_s`` is their time;
* the measured packets run as two halves, each timed from before its first
  packet to after its drain: the captured ``Pipeline`` enqueues through a
  pinned ring (``step_graph.PinnedFeed``) and the host runs ahead, so the
  per-packet host deltas (p50, p99) measure enqueue, and a half's time
  counts only once its drain returned;
* ``graphs_captured_in_span``: the CUDA graphs captured after the warm-up
  (``StepGraphs.stats``).  A capture inside the span is compile time
  leaking into the figure; the scenarios use one pad bucket each, so it
  reads 0.  It is reported, not hidden;
* the synced latency: a fresh pipeline on the same packets, ``N_WARM``
  warm, then up to ``SYNCED_PACKETS`` each followed by a drain; its p50
  and p99 against the budget (10 ms for mid360, 100 ms otherwise), also
  less the link's round trip (20 probes, each a tiny op on a fresh tensor
  and a host read).  The first pipeline is let go of before the second is
  built, its graphs with it.  The pass is skipped, as in bench.py, when
  the chained-op dispatch probe (``dispatch_ms``, before and after the
  span) reads above 3 ms or the warm-up took above 300 s.

``FAST_LIO_RESCORE=1`` runs bench.py's A/B (bench.py:252-266): converged
re-searches re-rank the cached candidate block, refused with bench.py's
message on the scenarios with the wide fallback; ``extra.rescore`` is the
value that ran.  On the card the scan's one full search is the kNN
kernel's candidates variant (``knn_backend`` "cuda_per_query_candidates"),
which writes the block the rescore re-ranks, so both sides of the A/B
search with the kernel; on the CPU both take the plain versions
("plain_candidates").  The runner does not profile: ``torch.profiler``
drops device activities late in a long process.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .. import sim
from ..batch import BatchPipeline
from ..config import Config
from ..pipeline import Pipeline, ScanPacket, SyncBuffer
from . import scenarios
from .microbench_knn import card

N_WARM = 6
SYNCED_PACKETS = 200  # the synced latency pass, after its warm-up
RTT_PROBES = 20
DISPATCH_PROBES = 40
# the synced pass would only measure a degraded link or a cold build
SKIP_DISPATCH_MS = 3.0
SKIP_WARM_S = 300.0
BATCH_PREFIX = "avia_batch"


def configure(name: str, cfg: Config, environ=os.environ) -> Config:
    """``cfg`` as the run takes it: with ``FAST_LIO_RESCORE=1`` the
    re-search re-ranks the cached candidate block (``rescore_research``),
    except where the wide fallback runs, which it would change
    (``pipeline._check_knn_backend`` refuses the pair): there the variable
    is ignored with bench.py's message."""
    if environ.get("FAST_LIO_RESCORE") != "1":
        return cfg
    if cfg.knn_wide_fallback:
        print(f"FAST_LIO_RESCORE=1 ignored: scenario {name!r} uses "
              "knn_wide_fallback and rescore would change search "
              "semantics (see make_knn_fn)", file=sys.stderr)
        return cfg
    return dataclasses.replace(cfg, rescore_research=True)


def make_packets(cfg: Config, data: sim.SimData) -> List[ScanPacket]:
    """The run's synced packets (bench.py:270-288): each scan pushed after
    the IMU samples up to its end (its stamp plus the scan period), then
    every packet popped."""
    period = (float(data.scan_stamps[1] - data.scan_stamps[0])
              if len(data.scan_stamps) > 1 else 0.1)
    sync = SyncBuffer(cfg)
    imu_i, packets = 0, []
    for k in range(len(data.scans)):
        stamp = data.scan_stamps[k]
        end = stamp + period
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= end + 1e-9:
            sync.push_imu(float(data.imu_t[imu_i]), data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        sync.push_lidar(float(stamp), data.scans[k], data.scan_pt_times[k])
        while (pkt := sync.pop_packet()) is not None:
            packets.append(pkt)
    return packets


def knn_backend(cfg: Config, device: torch.device) -> str:
    """The search the run's step makes: the per-query kernel, or its
    candidates variant under the rescore, on the card; the plain versions
    on the CPU."""
    name = "cuda_per_query" if device.type == "cuda" else "plain"
    return f"{name}_candidates" if cfg.rescore_research else name


def _drain(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tiny(y: torch.Tensor) -> torch.Tensor:
    return torch.add(y, y, alpha=1e-6)  # one elementwise kernel


def dispatch_ms(device: torch.device, n: int = DISPATCH_PROBES) -> float:
    """Chained tiny-op dispatch, ms a call (bench.py:292-305): ``n`` ops,
    each on the last one's output, then one host read."""
    y = _tiny(torch.zeros((8, 8), device=device))
    float(y[0, 0])
    t0 = time.perf_counter()
    for _ in range(n):
        y = _tiny(y)
    float(y[0, 0])
    return (time.perf_counter() - t0) / n * 1e3


def round_trips_ms(device: torch.device, n: int = RTT_PROBES) -> np.ndarray:
    """The link's round trip, ms (bench.py:363-376): each a tiny op on a
    fresh output and a host read of it."""
    z = _tiny(torch.zeros((8, 8), device=device))
    float(z[0, 0])
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        z = _tiny(z)
        float(z[0, 0])
        out.append(time.perf_counter() - t0)
    return 1e3 * np.asarray(out)


def _graphs(pipe) -> int:
    return len(pipe.graphs.stats()) if pipe.graphs is not None else 0


def _card(device: torch.device) -> Optional[str]:
    return card() if device.type == "cuda" else None


def _line(sps: float, extra: dict) -> dict:
    return {"metric": "lio_scan_rate", "value": round(sps, 2),
            "unit": "scans/s", "vs_baseline": round(sps / 100.0, 3),
            "extra": extra}


def latency_fields(lat_s: List[float], rtts_ms: np.ndarray,
                   budget_ms: float) -> dict:
    """bench.py's eight ``latency_*`` fields (bench.py:377-399): the synced
    per-packet wall's p50 and p99, the link's, and each less the link's."""
    rtt, rtt_p99 = (float(v) for v in np.percentile(rtts_ms, [50, 99]))
    p50, p99 = (float(v) for v in np.percentile(1e3 * np.asarray(lat_s),
                                                [50, 99]))
    c50, c99 = max(0.0, p50 - rtt), max(0.0, p99 - rtt_p99)
    return {"latency_p50_ms": round(p50, 2), "latency_p99_ms": round(p99, 2),
            "latency_rtt_ms": round(rtt, 2),
            "latency_rtt_p99_ms": round(rtt_p99, 2),
            "latency_corrected_p50_ms": round(c50, 2),
            "latency_corrected_p99_ms": round(c99, 2),
            "latency_budget_ms": budget_ms,
            "latency_budget_ok": bool(c99 < budget_ms)}


def run(name: str, duration: float = scenarios.DURATION_S,
        device="cuda") -> dict:
    """bench.py's ``main`` (bench.py:235-440) on scenario ``name``: its JSON
    line as a dict."""
    device = torch.device(device)
    cfg, data = scenarios.scenario(name, duration)
    cfg = configure(name, cfg)
    packets = make_packets(cfg, data)
    if len(packets) <= N_WARM + 1:
        raise ValueError(f"{name} at {duration} s makes {len(packets)} "
                         f"packets: more than {N_WARM + 1} are needed")
    pipe = Pipeline(cfg, device=device)

    t_start = time.perf_counter()
    for pkt in packets[:N_WARM]:
        pipe.process_packet(pkt)
    _drain(device)
    warm_s = time.perf_counter() - t_start
    graphs_warm = _graphs(pipe)
    dispatch_pre = dispatch_ms(device)

    meas = packets[N_WARM:]
    half = len(meas) // 2
    deltas, halves = [], []
    t_meas0 = time.perf_counter()
    for part in (meas[:half], meas[half:]):
        t0 = prev = time.perf_counter()
        for pkt in part:
            pipe.process_packet(pkt)
            now = time.perf_counter()
            deltas.append(now - prev)
            prev = now
        _drain(device)
        halves.append(len(part) / (time.perf_counter() - t0))
    scans_per_sec = len(meas) / (time.perf_counter() - t_meas0)
    graphs_in_span = _graphs(pipe) - graphs_warm
    dispatch_post = dispatch_ms(device)

    # the figures of the measured pipeline, read before it is let go of
    traj = pipe.get_trajectory()
    last = pipe.diags[-1] if pipe.diags else None
    n_eff_last = int(last.n_effective) if last else 0
    map_size = int(last.map_size) if last else 0
    del pipe, last

    lat = []
    skipped = max(dispatch_pre, dispatch_post) > SKIP_DISPATCH_MS or (
        warm_s > SKIP_WARM_S)
    if not skipped:
        pipe2 = Pipeline(cfg, device=device)
        for pkt in packets[:N_WARM]:
            pipe2.process_packet(pkt)
        _drain(device)
        for pkt in packets[N_WARM:N_WARM + SYNCED_PACKETS]:
            t0 = time.perf_counter()
            pipe2.process_packet(pkt)
            _drain(device)
            lat.append(time.perf_counter() - t0)
        del pipe2
    # bench.py's budget: a 100 Hz sensor's scan, else a 10 Hz one's
    budget_ms = 10.0 if name == "mid360" else 100.0
    if lat:
        lat_fields = latency_fields(lat, round_trips_ms(device), budget_ms)
    else:
        lat_fields = {"latency_skipped":
                      f"dispatch above {SKIP_DISPATCH_MS} ms or warm-up "
                      f"above {SKIP_WARM_S} s"}

    deltas_ms = np.sort(np.asarray(deltas)) * 1e3
    return _line(scans_per_sec, {
        "scenario": name,
        "ate_rmse_m": round(sim.ate_rmse_aligned(traj, data), 4),
        "ate_definition": "umeyama_aligned",
        "ate_rmse_raw_m": round(sim.ate_rmse(traj, data), 4),
        "scans": len(meas),
        "half1_scans_per_sec": round(halves[0], 2),
        "half2_scans_per_sec": round(halves[1], 2),
        "host_delta_p50_ms": round(float(deltas_ms[len(deltas_ms) // 2]), 3),
        "host_delta_p99_ms": round(float(deltas_ms[min(
            len(deltas_ms) - 1, int(len(deltas_ms) * 0.99))]), 3),
        "warm_s": round(warm_s, 1),
        "n_eff_last": n_eff_last,
        "map_size": map_size,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "knn_backend": knn_backend(cfg, device),
        "rescore": bool(cfg.rescore_research),
        **lat_fields,
        "dispatch_ms": [round(dispatch_pre, 3), round(dispatch_post, 3)],
        "card": _card(device),
        "graphs_captured_in_span": graphs_in_span,
    })


def run_batch(n: int, duration: float = scenarios.DURATION_S,
              device="cuda") -> dict:
    """bench.py's ``main_batch(n)`` (bench.py:153-232): n avia streams
    (``scenarios.batch_runs``) at bench.py's avia config through one
    ``BatchPipeline``, warm rounds until stream 0 has ``N_WARM`` poses,
    then the rest in one drained window: its JSON line as a dict, the
    aggregate scans/s and each stream's raw ATE."""
    device = torch.device(device)
    cfg = scenarios.config("avia")
    datas = scenarios.batch_runs(n, duration)
    bp = BatchPipeline(cfg, n, device=device)
    imu_i = [0] * n
    n_rounds = max(len(d.scans) for d in datas)

    def feed_round(k):
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

    k = 0
    while k < n_rounds and len(bp.trajectory[0]) < N_WARM:
        feed_round(k)
        while bp.spin_once():
            pass
        k += 1
    _drain(device)
    graphs_warm = _graphs(bp)

    t0 = time.perf_counter()
    scans0 = sum(len(t) for t in bp.trajectory)
    while k < n_rounds:
        feed_round(k)
        while bp.spin_once():
            pass
        k += 1
    _drain(device)
    wall = time.perf_counter() - t0
    scans = sum(len(t) for t in bp.trajectory) - scans0
    if not scans:
        raise ValueError(f"{BATCH_PREFIX}{n} at {duration} s leaves no "
                         "round after the warm-up")
    ates = [sim.ate_rmse(bp.get_trajectory(i), d) for i, d in enumerate(datas)]
    return _line(scans / wall, {
        "scenario": f"{BATCH_PREFIX}{n}",
        "aggregate_over_streams": n,
        "ate_rmse_m_per_stream": [round(a, 4) for a in ates],
        "scans": scans,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "card": _card(device),
        "graphs_captured_in_span": _graphs(bp) - graphs_warm,
    })


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", nargs="?", default="avia",
                    help=f"{', '.join(scenarios.NAMES)} or "
                         f"{BATCH_PREFIX}N (default avia)")
    ap.add_argument("--duration", type=float, default=scenarios.DURATION_S,
                    help="seconds of sim data (bench.py's 10 by default)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs the plain versions on the host")
    args = ap.parse_args(argv)
    batch = re.fullmatch(rf"{BATCH_PREFIX}(\d*)", args.scenario)
    if args.scenario not in scenarios.NAMES and not batch:
        ap.error(f"unknown scenario {args.scenario!r}")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device; nothing measured (--device cpu runs "
              "on the CPU)", file=sys.stderr)
        return 1
    if batch:  # N 4 when left out, as in bench.py
        out = run_batch(int(batch[1] or 4), args.duration, args.device)
    else:
        out = run(args.scenario, args.duration, args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

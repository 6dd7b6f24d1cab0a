"""What a captured step costs to capture and to run, for a checkout of the
port given by its root: each pad bucket's capture seconds and the bytes
the conditional nodes' body pools grew by in it, and the device
activities, busy ms and host syncs of a captured scan (or fleet round).

Run as a script, so that it can measure another checkout (an older commit
unpacked by ``git archive``) with the same code:

    python3 fast_lio_tpu_torch/tools/capture_cost.py [--root DIR] [runs ...]

``--root`` (default: the checkout this file is in) is put first on
``sys.path``, and everything is imported from there; only APIs that older
checkouts share are used (``torch.cuda.graph``, ``kernels.graph_if``'s
``_bodies`` and ``launches``, ``kernels.counts.settle``).  Runs: ``avia``
and ``ouster64`` (``chip_smoke.py`` phases 4-5's presets and sim runs) and
``fleet_batch4`` (phase 14's four avia streams, one batched step a round).
Each run starts one empty profiler session (``start_tracing``), then
takes ``WARM`` scans or rounds one by one (the capture among them), then
``PROFILED`` under ``torch.profiler`` (CPU and CUDA activities): device activities, busy ms (the union of their intervals)
and host syncs (``cudaStreamSynchronize``) a scan, and the conditional
nodes' kernels the profiler saw against those counted as run
(``kernels.counts``; the WHILE node's where the checkout has one): where
they differ, the profiler missed some of the activities.  A capture is
timed on the host clock from before ``torch.cuda.graph``'s entry to after
its exit (the capture and the graph's instantiation), synced at both ends;
the body pools' bytes are the segments the pools of ``kernels.graph_if``
reserve.  One JSON line per run, then the card's name and power limit.
Needs a card (exits 1 without one).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

WARM = 8
PROFILED = 4
RUNS = ("avia", "ouster64", "fleet_batch4")


def body_pool_bytes(graph_if) -> int:
    """What every body pool of ``graph_if`` reserves (segments' bytes)."""
    return sum(seg["total_size"] for _, pool in graph_if._bodies.values()
               for seg in pool.snapshot())


class CaptureTimer:
    """Wraps ``torch.cuda.graph`` while entered: each capture's seconds
    and the body pools' growth, in order."""

    def __init__(self, graph_if):
        self.graph_if = graph_if
        self.captures = []

    def __enter__(self):
        timer, real = self, torch.cuda.graph

        class timed(real):
            def __enter__(self):
                torch.cuda.synchronize()
                self._pools = body_pool_bytes(timer.graph_if)
                self._t0 = time.perf_counter()
                return super().__enter__()

            def __exit__(self, *exc):
                out = super().__exit__(*exc)
                torch.cuda.synchronize()
                timer.captures.append({
                    "capture_s": time.perf_counter() - self._t0,
                    "body_pool_bytes": (body_pool_bytes(timer.graph_if)
                                        - self._pools)})
                return out

        self.real, torch.cuda.graph = real, timed
        return self

    def __exit__(self, *exc):
        torch.cuda.graph = self.real


CONDITION_KERNELS = {"if": "set_condition_kernel",
                     "while": "while_condition_kernel"}


def profiled(step, n: int, counts, graph_if) -> dict:
    """``n`` calls of ``step`` under the profiler: per call, the device's
    activities, busy ms and host syncs, and the conditional nodes' kernels
    seen and counted as run."""
    from torch.profiler import ProfilerActivity, profile

    def counted():
        counts.settle()
        return {"if": graph_if.launches[0],
                "while": sum(getattr(graph_if, "while_launches", {}).values())}

    torch.cuda.synchronize()
    before = counted()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in counted().items()}
    spans, names, syncs = [], [], 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            names.append(ev.name)
        elif ev.name == "cudaStreamSynchronize":
            syncs += 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # the union of the intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"device_activities_per_scan": len(spans) / n,
            "device_busy_ms_per_scan": 1e-3 * busy / n,
            "host_syncs_per_scan": syncs / n,
            "condition_kernels_seen_per_scan": {
                k: sum(name in e for e in names) / n
                for k, name in CONDITION_KERNELS.items()},
            "condition_kernels_run_per_scan": {
                k: v / n for k, v in ran.items()}}


def scans(pipe, data):
    """Generator: each next() pushes one scan (with its IMU) and runs it."""
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
        yield k


def rounds(bp, datas):
    """Generator: each next() pushes every stream's next scan and runs the
    rounds that fire (``chip_smoke.round_feeder``)."""
    imu_i = [0] * len(datas)
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
        yield k


def start_tracing() -> None:
    """One empty profiler session before any capture of the process: in a
    graph captured before the first session the profiler saw a WHILE
    node's body once a replay where it ran several times
    (``tools/profile_scan.start_tracing``, which older checkouts lack)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


def measure(name: str) -> dict:
    """One run of the checkout first on ``sys.path`` (see the docstring)."""
    from fast_lio_tpu_torch import config, sim
    from fast_lio_tpu_torch.batch import BatchPipeline
    from fast_lio_tpu_torch.kernels import counts, graph_if
    from fast_lio_tpu_torch.pipeline import Pipeline
    from fast_lio_tpu_torch.tools import scenarios

    start_tracing()
    if name == "fleet_batch4":
        cfg, datas = scenarios.batch_scenario("avia_preset_batch4", 2.0)
        pipe = BatchPipeline(cfg, len(datas))
        feed = rounds(pipe, datas)
    else:
        if name == "avia":
            cfg = config.PRESETS["avia"]
            sim_cfg = sim.SimConfig(duration=2.0, n_rings=32, n_azimuth=400)
        else:
            cfg = dataclasses.replace(config.PRESETS["ouster64"],
                                      n_points_max=45056)
            sim_cfg = sim.SimConfig(duration=2.0, n_rings=64, n_azimuth=688,
                                    elev_min=-22.5, elev_max=22.5)
        pipe = Pipeline(cfg)
        feed = scans(pipe, sim.generate(sim_cfg))
    with CaptureTimer(graph_if) as timer:
        for _ in range(WARM):
            next(feed)
    return {"run": name, "captures": timer.captures,
            "body_pool_bytes_total": body_pool_bytes(graph_if),
            "graphs": {str(k): v for k, v in pipe.graphs.stats().items()},
            **profiled(lambda: next(feed), PROFILED, counts, graph_if)}


def main(argv=None) -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=here)
    ap.add_argument("runs", nargs="*", default=list(RUNS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("capture_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    for name in args.runs:
        print(json.dumps({"root": str(args.root), **measure(name),
                          "card": card}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

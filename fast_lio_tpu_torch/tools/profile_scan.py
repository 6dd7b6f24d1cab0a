"""Where a scan's time goes on the card: device busy and idle share, kernels
by device time, host syncs, and wall time per stage of ``lio_step``.

Run from the repository root on a machine with a CUDA device:

    python3 -m fast_lio_tpu_torch.tools.profile_scan [avia|ouster64 ...]

For each preset it feeds the same simulated run as ``chip_smoke.py`` through
``Pipeline`` on the card twice, in turns: the captured step (the default:
one CUDA graph per pad bucket, replayed, its gates conditional nodes) and
the eager one (``graphs=False``, every gate masked).  After ``--warm`` scans (the capture among them) it
measures, one after the other, windows of ``--scans`` scans each:

* a plain window: host clock around the scans, nothing added, the device
  drained at the end (scans/s);
* a ``torch.profiler`` window (CPU + CUDA activities): the
  union of device activity intervals (kernels and copies) over
  the window's wall time gives the device's busy and idle share; kernels are
  summed by name; ``cudaStreamSynchronize`` calls count the host syncs, by
  the op that made them, and ``cudaEventSynchronize`` calls the waits of
  the pinned feed ring (``step_graph.PinnedFeed``: the host ran that many
  scans ahead of the device).  The profiler slows the host, so this
  window's wall time is longer than the plain one's.  Beside it, what the
  step executed a scan: update passes, re-searches (narrow kNN searches)
  and wide searches, from the iterations and the kNN launches counted as
  run (``kernels.counts``, settled after the window: in the captured step
  the re-searches and the wide search are CUDA-graph IF nodes and the
  passes one WHILE node, so they run only where JAX's step runs them; the
  eager step runs every one); and the conditional nodes' kernels, counted
  as run against the profiler's count of them;
* eager only, a stage-timing window, where each stage function of
  ``lio_step`` is wrapped with ``torch.cuda.synchronize()`` on both sides.
  The syncs stop the host from running ahead of the device, so the stages
  sum to more than a plain scan: read them as shares.  The same window runs
  under ``torch.cuda.set_sync_debug_mode("warn")``, which names the line of
  the package behind each synchronising call.  A replay calls no stage
  function, so the captured step has no such window.

Prints one JSON line per preset and mode, then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
import warnings
from collections import Counter, defaultdict

import torch

from .. import config, pipeline, sim
from ..filter import ekf
from ..kernels import counts, graph_if
from ..kernels import knn as knn_kernel
from ..kernels import knn_grouped
from ..map import hash_map as hm

RUNS = {
    # the runs of chip_smoke.py's main-path phases
    "avia": (config.PRESETS["avia"],
             sim.SimConfig(duration=3.0, n_rings=32, n_azimuth=400)),
    "ouster64": (dataclasses.replace(config.PRESETS["ouster64"],
                                     n_points_max=45056),
                 sim.SimConfig(duration=2.0, n_rings=64, n_azimuth=688,
                               elev_min=-22.5, elev_max=22.5)),
}
# ouster64 with the region-grouped kNN kernel (chip_smoke.py's phase)
RUNS["ouster64_grouped"] = (
    dataclasses.replace(RUNS["ouster64"][0], knn_backend="grouped"),
    RUNS["ouster64"][1])

# (label, module, attribute) of each stage function lio_step calls; the kNN
# search (either backend) runs inside the update and is reported as its part
STAGES = (
    ("propagate_deskew", pipeline.imu_mod, "propagate_and_deskew"),
    ("fov_prune", hm, "prune_outside"),
    ("downsample", pipeline, "voxel_downsample"),
    ("update", ekf, "update_iterated"),
    ("update.knn", knn_kernel, "knn_search"),
    ("update.knn_grouped", knn_grouped, "knn_search"),
    ("insert_decisions", hm, "insert_decisions"),
    ("insert", hm, "insert"),
)

# the port's kNN kernels by the names the profiler gives them: every kernel
# of csrc/knn*.cu is a template named knn_<...>kernel, so one pattern also
# counts an earlier tree's kernels when two trees are profiled in turns; the
# grouped search's prep kernel is told apart from the search kernels
KNN_KERNEL = re.compile(r"\bknn_\w*kernel<")
KNN_PREP_KERNEL = "knn_grouped_prep_kernel<"


def is_knn_kernel(name: str) -> bool:
    """A kNN search kernel or the grouped search's prep kernel."""
    return KNN_KERNEL.search(name) is not None


COLLECTIVES = ("AllGather", "AllReduce")


def is_collective(name: str, op: str) -> bool:
    """An NCCL kernel of collective ``op`` (one of ``COLLECTIVES``)."""
    return "nccl" in name.lower() and op in name


# the conditional nodes' kernels (csrc/graph_if.cu): the IF node's set kernel
# and the WHILE node's condition kernel
CONDITION_KERNELS = {"if": "set_condition_kernel",
                     "while": "while_condition_kernel"}


def is_knn_prep_kernel(name: str) -> bool:
    return KNN_PREP_KERNEL in name


def is_knn_search_kernel(name: str) -> bool:
    return is_knn_kernel(name) and not is_knn_prep_kernel(name)


def _scan_feeder(pipe, data):
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


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _outermost_op(ev) -> str:
    """The outermost op above a runtime event (e.g. ``aten::item``)."""
    op, parent = None, ev.cpu_parent
    while parent is not None:
        if parent.name.startswith("aten::"):
            op = parent.name
        parent = parent.cpu_parent
    return str(op)


def start_tracing() -> None:
    """One empty ``torch.profiler`` session with CUDA activities.  Call it
    before a process captures its first graph: in a graph captured before
    the process's first session, the profiler saw a WHILE node's body once
    a replay where it ran several times (on an H100 with PyTorch 2.11 and
    CUDA 12.8); in a graph captured after one, every pass but a rare
    condition kernel (one in 16 and one in 50 in two windows).  The
    ``condition_kernels_per_scan`` of a window, against the condition
    kernels counted as run (``executed_per_scan``), tell what it missed."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


def profile_window(step, n_scans: int) -> dict:
    """Profile ``n_scans`` calls of ``step`` (each runs one scan)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_scans):
            step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    dev_type = torch.autograd.DeviceType.CUDA
    intervals, by_kernel, calls = [], defaultdict(float), defaultdict(int)
    syncs_by_op = defaultdict(int)  # by the op that synchronised
    feed_waits = 0
    for ev in prof.events():
        if ev.device_type == dev_type:
            intervals.append((ev.time_range.start, ev.time_range.end))
            by_kernel[ev.name] += ev.time_range.elapsed_us()
            calls[ev.name] += 1
        elif ev.name == "cudaStreamSynchronize":
            syncs_by_op[_outermost_op(ev)] += 1
        elif ev.name == "cudaEventSynchronize":
            feed_waits += 1
    syncs = sum(syncs_by_op.values())
    # no device activity in the trace means the profiler did not see the
    # card: the device numbers are then not measured (None), not zero
    busy_s = _busy_us(intervals) * 1e-6 if intervals else None
    top = sorted(by_kernel, key=by_kernel.get, reverse=True)[:10]
    return {
        "wall_ms_per_scan": 1e3 * wall_s / n_scans,
        "device_busy_ms_per_scan": busy_s and 1e3 * busy_s / n_scans,
        "device_idle_share": busy_s and 1.0 - busy_s / wall_s,
        "device_activities_per_scan": len(intervals) / n_scans,
        "host_syncs_per_scan": syncs / n_scans,
        "feed_waits_per_scan": feed_waits / n_scans,
        "host_syncs_by_op_per_scan": {
            k: v / n_scans for k, v in sorted(syncs_by_op.items(),
                                              key=lambda kv: -kv[1])},
        "knn_kernel_ms_per_scan": 1e-3 * sum(
            v for k, v in by_kernel.items() if is_knn_kernel(k)) / n_scans,
        "knn_search_launches_per_scan": sum(
            n for k, n in calls.items() if is_knn_search_kernel(k)) / n_scans,
        # the conditional nodes' kernels as the profiler saw them; against
        # the counts of them run (``executed_per_scan``) they tell whether
        # the profiler saw every pass of a WHILE node's body
        "condition_kernels_per_scan": {
            kind: sum(n for k, n in calls.items() if name in k) / n_scans
            for kind, name in CONDITION_KERNELS.items()},
        # NCCL's kernels: a sharded step's collectives as the card ran them
        "collective_kernels_per_scan": {
            op: sum(n for k, n in calls.items() if is_collective(k, op))
            / n_scans for op in COLLECTIVES},
        "top_device_ms_per_scan": [
            {"name": name[:80], "ms": 1e-3 * by_kernel[name] / n_scans,
             "calls": calls[name] / n_scans} for name in top],
    }


def executed_per_scan(cfg, gated: bool, iterations, ran) -> dict:
    """What the step executed a scan over a window: the update's passes
    (the iterations where a WHILE node runs them, ``gated``, else every pass
    of an updating scan), the re-searches and wide searches (the kNN search
    launches counted as run at R = 8 and R = 27, or under
    ``rescore_research`` the candidates variant's one search a scan;
    ``ran`` is ``counts.since`` over the window, settled), and their sum,
    which the profiler's ``knn_search_launches_per_scan`` must equal."""
    n = len(iterations)
    f64 = cfg.compute_dtype == "float64"
    if cfg.knn_backend == "grouped":
        search = knn_grouped.launches
    elif cfg.rescore_research:  # the scan's one search, with its block
        search = (knn_kernel.cand_launches_f64 if f64
                  else knn_kernel.cand_launches)
    elif f64:
        search = knn_kernel.launches_f64
    else:
        search = knn_kernel.launches
    index = [id(c) for c in counts.counters()]
    by_r = ran[index.index(id(search))]
    passes = (sum(iterations) if gated else
              sum(cfg.max_iteration + 1 for i in iterations if i > 0))
    conditions = {"if": ran[index.index(id(graph_if.launches))],
                  "while": ran[index.index(id(graph_if.while_launches))]}
    return {"iterations_per_scan": sum(iterations) / n,
            "passes_run_per_scan": passes / n,
            "condition_kernels_counted_per_scan": {
                kind: sum(c.values()) / n for kind, c in conditions.items()},
            "researches_per_scan": by_r.get(8, 0) / n,
            "wide_searches_per_scan": by_r.get(27, 0) / n,
            "knn_search_launches_counted_per_scan": sum(by_r.values()) / n}


def stage_window(step, n_scans: int) -> dict:
    """Synced wall time per stage over ``n_scans`` calls of ``step``."""
    acc = defaultdict(float)
    saved = []

    def timed(label, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[label] += time.perf_counter() - t0
            return out
        return wrapper

    for label, mod, attr in STAGES:
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, timed(label, fn))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_scans):
                step()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    stages = {label: 1e3 * acc[label] / n_scans for label, _m, _a in STAGES}
    outside = wall_s - sum(v for k, v in acc.items()
                           if not k.startswith("update.knn"))
    stages["outside_stages"] = 1e3 * outside / n_scans
    # the syncs of this tool's own wrappers are left out
    lines = Counter(
        f"{w.filename.split('fast_lio_tpu_torch/')[-1]}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message)
        and "fast_lio_tpu_torch/" in w.filename and "/tools/" not in w.filename)
    return {"wall_ms_per_scan": 1e3 * wall_s / n_scans, "stage_ms_per_scan": stages,
            "host_syncs_by_line_per_scan": {
                k: v / n_scans for k, v in lines.most_common()}}


def run(name: str, n_scans: int, warm: int, graphs: bool) -> dict:
    cfg, sim_cfg = RUNS[name]
    data = sim.generate(sim_cfg)
    windows = 3 if not graphs else 2
    if warm + windows * n_scans > len(data.scans):
        raise ValueError(f"{name}: {len(data.scans)} scans < warm + "
                         f"{windows} * scans")
    pipe = pipeline.Pipeline(cfg, graphs=graphs)
    feeder = _scan_feeder(pipe, data)
    step = functools.partial(next, feeder)
    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_scans):
        step()
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / n_scans
    n_done = len(pipe.diags)
    counts.settle()
    before = counts.snapshot()
    profile = profile_window(step, n_scans)
    counts.settle()
    profile.update(executed_per_scan(
        cfg, graphs, [int(d.iterations) for d in pipe.diags[n_done:]],
        counts.since(before)))
    out = {"tool": "profile_scan", "preset": name,
           "mode": "captured" if graphs else "eager", "scans": n_scans,
           "warm_scans": warm, "plain_wall_ms_per_scan": plain_ms,
           "scans_per_s": 1e3 / plain_ms, "profile": profile}
    if graphs:
        out["graphs"] = pipe.graphs.stats()
    else:
        out["stages"] = stage_window(step, n_scans)
    out["feed_waits"] = pipe.feed.waits
    hc = pipe.health_check()
    if hc["nan"]:
        raise RuntimeError(f"{name}: NaN in the state")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("presets", nargs="*", metavar="preset",
                    help=f"any of {', '.join(RUNS)} (default: all)")
    ap.add_argument("--scans", type=int, default=5,
                    help="scans in each of the three windows")
    ap.add_argument("--warm", type=int, default=5, help="scans run first")
    args = ap.parse_args(argv)
    unknown = set(args.presets) - set(RUNS)
    if unknown:
        ap.error(f"unknown presets {sorted(unknown)}; choose from {list(RUNS)}")
    if not torch.cuda.is_available():
        print("profile_scan: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    start_tracing()
    for name in args.presets or RUNS:
        # captured first: a process that had profiled several windows
        # before named some kernels inside IF nodes wrongly (PERF.md)
        for graphs in (True, False):
            print(json.dumps(run(name, args.scans, args.warm, graphs)),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

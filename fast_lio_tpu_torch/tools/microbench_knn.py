"""Microbenchmark of the port's two kNN searches on the card: the per-query
kernel (``kernels/knn.py``), in float32 and float64, and the region-grouped
search (``kernels/knn_grouped.py``, float32 only), each at the shapes of
the main path, on the queries in the main path's order and shuffled.

Run from the repository root on a machine with a CUDA device:

    python3 -m fast_lio_tpu_torch.tools.microbench_knn [--reps 50]

It is the port of the JAX package's ``tools/microbench_knn.py`` and
``tools/microbench_grouped.py``, and ``chip_smoke.py`` phase 2 times its
kernels with the functions here.  For each search it gives:

* ``device_us``: the search kernel's device time per launch, from
  ``torch.profiler``'s device activities; for the grouped search, the rest
  of its device activity per search (its prep) is ``prep_device_us``; the
  grouped search's prep kernel is also timed alone (``grouped_prep``);
  ``device_timer`` says "profiler", or "cuda_events_graph" where no
  profiler window saw the kernel and ``graph_us`` stands in;
* ``graph_us``: the stream time of one whole search, prep included: 100
  wrapper calls captured in one ``torch.cuda.CUDAGraph``, replayed between
  one pair of CUDA events after a warm-up, divided by 100;
* ``enqueue_us``: the host clock around one wrapper call with no
  synchronize (median), which is what the eager main path pays;
* ``plain_us``: CUDA events around back-to-back calls of the plain PyTorch
  version, host enqueue included (it is no yardstick of speed);
* ``bound_us``: ``kernels/bounds.knn_bound`` of the same search
  (``prep_bound`` for the prep).

The map stays warm in L2 from one call to the next, as on the main path,
where the map prune reads the whole map just before the search.

The map holds 5 simulated scans; the queries are those the main path
searches for a 6th, at its true pose ("main"), and the same queries
permuted by a seeded numpy permutation ("shuffled", incoherent order): the
scan's voxel centroids from the pipeline's downsample, in its voxel order
and padded as it pads, N = 8192 (``n_ds_max``), at R = 8, B = 64 (the avia
preset) and at R = 27, B = 128 (the ouster64 preset, whose wide fallback
searches all of them); H = 2^15.  The float64 rows (``knn_f64_r8``, ``knn_f64_r27``) search the same
map and queries in float64, moved off the float32 grid by less than half a
float32 ulp (``off_float32``).  The batched rows (``knn_batched_r8``, ...,
``knn_batched_f64_r27``) search ``STREAMS`` maps at once, one launch over
the kernel's stream axis (``knn_search_cuda_batched``, the batched step's
search): each map made as above from the sim run of another seed (0-3,
with 0.01 m of range noise, which the seed draws), each stream its own
scan's queries; their plain version is the plain
search run per stream, their bound the streams' bounds added.  The
candidates rows (``knn_cand_r8``, ``knn_cand_f64_r8``,
``knn_cand_batched_r8``) time the kernel's candidates variant, the rescore
re-search's search (``knn_search_candidates_cuda`` and ``_batched``), on
the R = 8 cases: their plain version is ``knn_search(...,
return_candidates=True)``, their bound ``bounds.knn_candidates_bound`` (the
search's bytes and the candidate block's).  Prints one JSON line per
search and query order, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import config, sim
from ..kernels import bounds, build
from ..kernels import knn
from ..kernels import knn_grouped as kg
from ..map import hash_map as hm
from ..ops.voxel_grid import voxel_downsample
from .profile_scan import is_knn_prep_kernel, is_knn_search_kernel

GRAPH_CALLS = 100
# profiler windows tried before a time falls back to CUDA events: late in a
# long process torch.profiler can drop or misname device activities
PROFILER_WINDOWS = 3


class Case(NamedTuple):
    tag: str
    order: str  # "main" or "shuffled"
    m: hm.Map
    cfg: hm.MapConfig
    queries: torch.Tensor
    wide: bool


# tag: (preset, sim run, wide, seed of the shuffle)
CASES = {
    "r8": (config.PRESETS["avia"],
           sim.SimConfig(duration=0.75, n_rings=32, n_azimuth=400),
           False, 0),
    "r27": (config.PRESETS["ouster64"],
            sim.SimConfig(duration=0.75, n_rings=64, n_azimuth=688,
                          elev_min=-22.5, elev_max=22.5),
            True, 1),
}
SCAN = 5  # the scan searched; the map holds the scans before it
STREAMS = 4  # the batched rows' maps, sim seeds 0..STREAMS-1
STREAM_RANGE_NOISE = 0.01  # m: the sim's seed draws only noise, so the
# batched rows' runs take this much range noise to make their maps differ


def map_config(preset: config.Config) -> hm.MapConfig:
    """The map configuration ``Pipeline`` makes of a preset."""
    return hm.make_config(voxel_size=preset.filter_size_map,
                          h_log2=preset.map_h_log2,
                          bucket_slots=preset.map_bucket_slots,
                          cell_multiplier=preset.map_cell_multiplier)


def main_path_queries(preset: config.Config, scan: np.ndarray,
                      rot: np.ndarray, pos: np.ndarray,
                      device) -> torch.Tensor:
    """The queries the main path searches for one scan (LiDAR frame) at
    pose (rot, pos), narrow and wide alike: the voxel centroids of
    ``lio_step``'s downsample (the preset's leaf, pad and key bound; voxel
    order, zero pads) moved to the world."""
    pts = torch.tensor(scan, dtype=torch.float32, device=device)
    ds, _ds_mask = voxel_downsample(
        pts, torch.ones(len(pts), dtype=torch.bool, device=device),
        preset.filter_size_surf, preset.n_ds_max,
        coord_bound=preset.det_range * 1.25 + 5.0)
    rot_t = torch.tensor(rot, dtype=torch.float32, device=device)
    return ds @ rot_t.T + torch.tensor(pos, dtype=torch.float32,
                                       device=device)


def off_float32(m: hm.Map, queries: torch.Tensor, seed: int):
    """The map and queries in float64, each point coordinate scaled by
    1 + u·2^-26 with u uniform in [-1, 1) from a seeded numpy generator:
    less than half a float32 ulp, so the values round back to the float32
    ones, yet float32 cannot hold them.  A float64 search that casts them to
    float32, or computes in float32, then leaves the plain float64 version
    in its low bits.  The w channel (0 live, 1e18 free) is kept."""
    rng = np.random.default_rng(seed)

    def nudge(x: torch.Tensor) -> torch.Tensor:
        u = torch.from_numpy(rng.uniform(-1.0, 1.0, tuple(x.shape)))
        return x.double() * (1.0 + u.to(x.device) * 2.0**-26)

    packed = m.packed.double()
    B = packed.shape[-1] // 4
    packed[:, :3 * B] = nudge(packed[:, :3 * B])
    return hm.Map(packed, m.dropped), nudge(queries).contiguous()


class BatchedCase(NamedTuple):
    tag: str
    maps: list  # per stream, hm.Map with its dump row
    rows: torch.Tensor  # (S, H + 1, 4B), the maps stacked
    cfg: hm.MapConfig
    queries: torch.Tensor  # (S, N, 3)
    wide: bool

    @property
    def packed(self) -> torch.Tensor:
        """(S, H, 4B): the maps as the batched step passes them, (H + 1)
        rows apart."""
        return self.rows[:, :self.cfg.num_buckets]


def make_batched_case(tag: str, streams: int = STREAMS, device="cuda",
                      dtype=torch.float32) -> BatchedCase:
    """``streams`` cases of ``tag`` in the main order, stream s from the sim
    run of seed s with ``STREAM_RANGE_NOISE`` (so each stream has its own
    map and queries), stacked with their dump rows."""
    maps, qs = [], []
    for s in range(streams):
        case = make_case(tag, "main", device, dtype, sim_seed=s)
        m = hm.from_packed(case.m.packed, case.m.dropped)
        maps.append(m)
        qs.append(case.queries)
    return BatchedCase(tag, maps, torch.stack([m.rows for m in maps]),
                       case.cfg, torch.stack(qs), case.wide)


def make_case(tag: str, order: str = "main", device="cuda",
              dtype=torch.float32, sim_seed: int = None) -> Case:
    """A map filled from 5 simulated scans (world frame, true poses) and
    the queries of the main path's search of the 6th (``main_path_queries``)
    in its order ("main") or permuted by a seeded numpy permutation
    ("shuffled").  Built in float32; a float64 case holds those values moved
    off the float32 grid (``off_float32``).  ``sim_seed`` gives the sim run
    that seed and ``STREAM_RANGE_NOISE``."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {dtype}: torch.float32 or torch.float64")
    if order not in ("main", "shuffled"):
        raise ValueError(f"order {order!r}: 'main' or 'shuffled'")
    preset, sim_cfg, wide, seed = CASES[tag]
    cfg = map_config(preset)
    if sim_seed is not None:
        sim_cfg = dataclasses.replace(sim_cfg, seed=sim_seed,
                                      range_noise=STREAM_RANGE_NOISE)
    data = sim.generate(sim_cfg)
    m = hm.make_map(cfg, torch.float32, device)
    for k in range(SCAN):
        pw = data.scans[k] @ data.gt_rot[k].T + data.gt_pos[k]
        p = torch.tensor(pw, dtype=torch.float32, device=device)
        on = torch.ones(len(p), dtype=torch.bool, device=device)
        m = hm.insert(m, cfg, p, on, on)
    q = main_path_queries(preset, data.scans[SCAN], data.gt_rot[SCAN],
                          data.gt_pos[SCAN], device)
    if dtype == torch.float64:
        m, q = off_float32(m, q, seed + 200)
    if order == "shuffled":
        perm = np.random.default_rng(seed + 100).permutation(q.shape[0])
        q = q[torch.from_numpy(perm).to(device)].contiguous()
    return Case(tag, order, m, cfg, q, wide)


def device_us(fn: Callable, calls: int,
              is_search: Callable[[str], bool] = is_knn_search_kernel):
    """(search kernel us per launch, other device us per call, search
    launches per call) over ``calls`` calls under ``torch.profiler``; a
    window that saw no search kernel is tried again, up to
    ``PROFILER_WINDOWS`` windows, and after that the times are None."""
    return profiled_windows(fn, calls, is_search)[0]


def profiled_windows(fn: Callable, calls: int,
                     is_search: Callable[[str], bool]):
    """(``device_us``'s tuple, the profiler windows it took)."""
    for windows in range(1, PROFILER_WINDOWS + 1):
        got = profiled_us(fn, calls, is_search)
        if got[0] is not None:
            break
    return got, windows


def profiled_us(fn: Callable, calls: int, is_search: Callable[[str], bool]):
    """One profiler window of ``device_us``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA
    search, other, n = 0.0, 0.0, 0
    for ev in prof.events():
        if ev.device_type != dev:
            continue
        if is_search(ev.name):
            search += ev.time_range.elapsed_us()
            n += 1
        else:
            other += ev.time_range.elapsed_us()
    if n == 0:
        return None, None, 0.0
    return search / n, other / calls, n / calls


def kernel_us(fn: Callable, calls: int,
              is_kernel: Callable[[str], bool] = is_knn_search_kernel
              ) -> dict:
    """``device_us`` of ``fn``'s kernel with ``device_timer`` "profiler";
    where no profiler window saw the kernel, ``graph_us`` of the whole call
    (CUDA events) stands in with ``device_timer`` "cuda_events_graph".
    Also ``profiler_windows`` (the windows taken), ``graph_us``,
    ``prep_device_us`` (the rest of the device time a call, None without
    the profiler) and ``launches_per_call``."""
    (dev, rest, per_call), windows = profiled_windows(fn, calls, is_kernel)
    graph = graph_us(fn)
    return {"device_us": graph if dev is None else dev,
            "device_timer": "cuda_events_graph" if dev is None else "profiler",
            "profiler_windows": windows, "prep_device_us": rest,
            "launches_per_call": per_call, "graph_us": graph}


def graph_us(fn: Callable, calls: int = GRAPH_CALLS, replays: int = 10):
    """Stream time of one call: ``calls`` calls captured in one CUDA graph,
    replayed between one pair of events (median of ``replays``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(1e3 * start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def enqueue_us(fn: Callable, reps: int) -> float:
    """Median host time of one call, no synchronize inside the timing (the
    device drains between calls)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def stream_us(fn: Callable, calls: int) -> float:
    """CUDA events around ``calls`` back-to-back calls, per call (the host's
    enqueue included where it is the slower)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / calls


def time_search(fn: Callable, reps: int,
                is_search: Callable[[str], bool] = is_knn_search_kernel
                ) -> dict:
    """The three numbers of one search (see the module's docstring)."""
    t = kernel_us(fn, reps, is_search)
    t["search_launches_per_call"] = t.pop("launches_per_call")
    return {**t, "enqueue_us": enqueue_us(fn, reps)}


def searches(case: Case) -> dict:
    """name -> (kernel wrapper call, plain version call, kernel-name test)
    of the case: in float64 the per-query kernel only."""
    m, cfg, q, wide = case.m, case.cfg, case.queries, case.wide
    if q.dtype == torch.float64:
        return {f"knn_f64_{case.tag}": (
            lambda: knn.knn_search_cuda(m.packed, cfg, q, wide=wide),
            lambda: hm.knn_search(m, cfg, q, wide=wide),
            is_knn_search_kernel)}
    return {
        f"knn_{case.tag}": (
            lambda: knn.knn_search_cuda(m.packed, cfg, q, wide=wide),
            lambda: hm.knn_search(m, cfg, q, wide=wide),
            is_knn_search_kernel),
        f"grouped_{case.tag}": (
            lambda: kg.knn_search_cuda(m.packed, cfg, q, wide=wide),
            lambda: kg.knn_search_grouped_plain(m, cfg, q, wide=wide),
            is_knn_search_kernel),
        f"grouped_prep_{case.tag}": (
            lambda: kg.group_queries_cuda(q, cfg, wide),
            lambda: kg.group_queries(q, cfg, wide),
            is_knn_prep_kernel),
    }


def registers(lib: str, kernel: str, R: int, scalar: str = ""
              ) -> Optional[dict]:
    """ptxas usage of ``kernel<R>`` (``kernel<T, R>`` with ``scalar`` the
    mangled T: "f" float, "d" double) in ``csrc/<lib>.cu``'s build log."""
    for entry, use in build.kernel_usage(lib).items():
        if f"{kernel}I{scalar}Li{R}E" in entry:
            return use
    return None


def measure(case: Case, reps: int, with_plain: bool = True) -> dict:
    """name -> row of times for both searches of the case and the grouped
    search's prep."""
    N = case.queries.shape[0]
    search_bound = bounds.knn_bound(case.m, case.cfg, case.queries,
                                    case.wide)
    rows = {}
    for name, (fn, plain, is_kernel) in searches(case).items():
        if is_kernel is is_knn_prep_kernel:
            n_groups = int(kg.group_queries(case.queries, case.cfg,
                                            case.wide).n_groups[0])
            bound = bounds.prep_bound(N, n_groups)
        else:
            bound = search_bound
        row = {"name": name, "order": case.order,
               "shape": dict(N=N, R=27 if case.wide else 8,
                             B=case.cfg.bucket_slots,
                             H=case.cfg.num_buckets),
               **time_search(fn, reps, is_kernel),
               "bound_us": 1e3 * bound.ms, "bound_by": bound.by,
               "distinct_rows": bound.distinct_rows}
        if with_plain:
            row["plain_us"] = stream_us(plain, max(5, reps // 5))
        rows[name] = row
    return rows


def measure_batched(case: BatchedCase, reps: int) -> dict:
    """The row of the batched search of ``case`` (one launch over its
    streams): its times, the plain search per stream, the streams' bound."""
    cfg, q, wide = case.cfg, case.queries, case.wide
    S, N = q.shape[:2]
    bound = bounds.knn_bound_streams(case.maps, cfg, q, wide)
    f64 = q.dtype == torch.float64
    name = f"knn_batched{'_f64' if f64 else ''}_{case.tag}"
    return {name: {
        "name": name, "order": "main",
        "shape": dict(S=S, N=N, R=27 if wide else 8, B=cfg.bucket_slots,
                      H=cfg.num_buckets),
        **time_search(lambda: knn.knn_search_cuda_batched(
            case.packed, cfg, q, wide=wide), reps),
        "bound_us": 1e3 * bound.ms, "bound_by": bound.by,
        "distinct_rows": bound.distinct_rows,
        "plain_us": stream_us(lambda: [
            hm.knn_search(m, cfg, q[s], wide=wide)
            for s, m in enumerate(case.maps)], max(5, reps // 5))}}


def _shape(cfg: hm.MapConfig, q: torch.Tensor, R: int) -> dict:
    lead = dict(S=q.shape[0]) if q.dim() == 3 else {}
    return dict(**lead, N=q.shape[-2], R=R, B=cfg.bucket_slots,
                H=cfg.num_buckets)


def measure_candidates(case: Case, reps: int, with_plain: bool = True
                       ) -> dict:
    """The row of the candidates variant on ``case`` (R = 8): its times,
    its bound (the search's and the block's bytes), the plain version's
    time."""
    m, cfg, q = case.m, case.cfg, case.queries
    if case.wide:
        raise ValueError("the candidate block is the R = 8 search's")
    bound = bounds.knn_candidates_bound(m, cfg, q)
    name = (f"knn_cand{'_f64' if q.dtype == torch.float64 else ''}"
            f"_{case.tag}")
    row = {"name": name, "order": case.order, "shape": _shape(cfg, q, 8),
           **time_search(lambda: knn.knn_search_candidates_cuda(
               m.packed, cfg, q), reps),
           "bound_us": 1e3 * bound.ms, "bound_by": bound.by,
           "distinct_rows": bound.distinct_rows, "bound_bytes": bound.nbytes}
    if with_plain:
        row["plain_us"] = stream_us(lambda: hm.knn_search(
            m, cfg, q, return_candidates=True), max(5, reps // 5))
    return {name: row}


def measure_candidates_batched(case: BatchedCase, reps: int) -> dict:
    """``measure_candidates`` of one launch over the streams of ``case``
    (``knn_search_candidates_cuda_batched``): the plain version per
    stream, the streams' bounds added."""
    cfg, q = case.cfg, case.queries
    bound = bounds.knn_candidates_bound_streams(case.maps, cfg, q)
    name = (f"knn_cand_batched{'_f64' if q.dtype == torch.float64 else ''}"
            f"_{case.tag}")
    return {name: {
        "name": name, "order": "main", "shape": _shape(cfg, q, 8),
        **time_search(lambda: knn.knn_search_candidates_cuda_batched(
            case.packed, cfg, q), reps),
        "bound_us": 1e3 * bound.ms, "bound_by": bound.by,
        "distinct_rows": bound.distinct_rows, "bound_bytes": bound.nbytes,
        "plain_us": stream_us(lambda: [
            hm.knn_search(m, cfg, q[s], return_candidates=True)
            for s, m in enumerate(case.maps)], max(5, reps // 5))}}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50,
                    help="calls per profiler window and enqueue median")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench_knn: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    build.build_all(build.LIBS)
    for dtype in (torch.float32, torch.float64):
        for tag in CASES:
            for order in ("main", "shuffled"):
                case = make_case(tag, order, dtype=dtype)
                rows = measure(case, args.reps)
                if not case.wide:
                    rows.update(measure_candidates(case, args.reps))
                for row in rows.values():
                    print(json.dumps(row), flush=True)
            bcase = make_batched_case(tag, dtype=dtype)
            rows = measure_batched(bcase, args.reps)
            if not bcase.wide:
                rows.update(measure_candidates_batched(bcase, args.reps))
            for row in rows.values():
                print(json.dumps(row), flush=True)
    for lib in ("knn", "knn_grouped"):
        print(json.dumps({"ptxas": lib, "kernels": build.kernel_usage(lib)}),
              flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

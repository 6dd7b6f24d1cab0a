"""Microbenchmark of the port's sorted segmented mean on the card (the
voxel downsample's sums, counts and division, ``kernels/segment_sum.py``),
at the shapes of the main path, in float32 and float64, single and over a
stream axis of ``STREAMS`` lanes.

Run from the repository root on a machine with a CUDA device:

    python3 -m fast_lio_tpu_torch.tools.microbench_segment_sum [--reps 50]

``chip_smoke.py`` phase 2 holds the kernel to its plain version and times
it with the functions here.  The inputs are the main path's own: a short
sim run of the preset through an eager ``Pipeline`` on the card, each
step's downsample inputs kept (its deskewed points, padded to the preset's
``n_points_max``, their mask and intensities), then sorted by
``voxel_grid.voxel_segments`` as the downsample sorts them.  The single
case is the last step's; the batched case stacks the last ``STREAMS``
steps' (each lane its own scan).  The float64 cases hold the same points
moved off the float32 grid by less than half a float32 ulp
(``microbench_knn.off_float32``'s nudge), sorted again in float64.

For each case: ``device_us`` (``torch.profiler``, per launch; where no
profiler window saw the kernel, ``graph_us``, as ``device_timer`` says),
``graph_us`` (a CUDA graph of 100 wrapper calls, per call),
``enqueue_us`` (host clock, no sync), ``plain_us`` (CUDA events around
back-to-back calls of the plain version on the card), ``library_us`` (the
plain version's two ``index_add_`` calls and its division in a CUDA graph
of 100, per call, as ``graph_us`` times the kernel) and ``bound_us``
(``kernels/bounds.segment_mean_bound``) with its three terms
(``bound_terms_us``: bytes, operations, and ``chain_us``, the longest
segment's chain of dependent adds); ``shape`` says what the design faces:
the non-empty segments, the longest and the 99th percentile of their
lengths, over the lanes.  For the main path's single cases also
``segment_reduce``, what ``segment_reduce_probe`` finds of the same
function through ``torch.segment_reduce``.

Besides the main path's inputs, ``make_cases(ADVERSARIAL)`` gives the
cases the kernel's ownership of points and ids must survive (the
generators in ``ADVERSARIAL_CASES``, which
``tests/test_torch_segment_sum.py`` runs too): every kept point in one
segment longer than a block's staged tile, every point dead, no point,
every id kept with live points cut into the overflow, segments of 1 and of
a block's range ± 1 points across every block boundary with the last kept
point on one, and 3 float32 columns at an odd N (rows off 16 bytes).

Prints one JSON line per case, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import pipeline, sim
from ..kernels import bounds, build
from ..kernels import segment_sum as seg
from ..ops.voxel_grid import voxel_segments
from . import bench_scaling, profile_scan
from .microbench_knn import (card, enqueue_us, graph_us, kernel_us,
                             stream_us)

STREAMS = 4  # lanes of the batched case: the last STREAMS steps
SCANS = 7  # steps of the sim run (the first one seeds the map)
NUDGE_SEED = 300
RUNS = ("avia", "ouster64")  # the main path's cases
ADVERSARIAL = "adversarial"  # make_cases' tag of the generated cases
ADVERSARIAL_SEED = 400
# the points a block owns in a launch over one lane (csrc/segment_sum.cu,
# Narrow): the block_edges case cuts its segments around it
BLOCK_POINTS = 96


class Case(NamedTuple):
    tag: str
    cols: torch.Tensor  # (N, C) or (S, N, C)
    live: torch.Tensor
    seg_id: torch.Tensor
    n_out: int

    @property
    def batched(self) -> bool:
        return self.cols.dim() == 3


def downsample_inputs(tag: str, device="cuda", scans: int = SCANS) -> tuple:
    """The preset's cfg and the downsample inputs (pts, mask, feats) of each
    step of ``scans`` scans of its ``profile_scan.RUNS`` sim run, through an
    eager ``Pipeline`` on ``device``."""
    cfg, sim_cfg = profile_scan.RUNS[tag]
    data = sim.generate(sim_cfg)
    kept = []
    downsample = pipeline.voxel_downsample

    def keep(pts, mask, leaf, n_out, feats=None, coord_bound=None):
        kept.append((pts.clone(), mask.clone(), feats.clone()))
        return downsample(pts, mask, leaf, n_out, feats=feats,
                          coord_bound=coord_bound)

    pipe = pipeline.Pipeline(cfg, device=device, graphs=False)
    pipeline.voxel_downsample = keep
    try:
        for _ in bench_scaling.run_scans(pipe, data, scans):
            pass
    finally:
        pipeline.voxel_downsample = downsample
    return cfg, kept


def _off_float32(x: torch.Tensor, rng) -> torch.Tensor:
    u = torch.from_numpy(rng.uniform(-1.0, 1.0, tuple(x.shape)))
    return x.double() * (1.0 + u.to(x.device) * 2.0**-26)


def make_cases(tag: str, device="cuda", streams: int = STREAMS) -> dict:
    """name -> Case: the single and batched cases of ``tag`` (a
    ``profile_scan.RUNS`` run, or ``ADVERSARIAL``: each generator's) in
    float32 and float64."""
    if tag == ADVERSARIAL:
        return adversarial_cases(device, streams)
    cfg, kept = downsample_inputs(tag, device)
    rng = np.random.default_rng(NUDGE_SEED)
    cases = {}
    for dtype in (torch.float32, torch.float64):
        per_step = []
        for pts, mask, feats in kept[-streams:]:
            if dtype == torch.float64:
                pts, feats = _off_float32(pts, rng), _off_float32(feats, rng)
            per_step.append(voxel_segments(
                pts, mask, cfg.filter_size_surf, cfg.n_ds_max, feats,
                cfg.det_range * 1.25 + 5.0))
        suffix = "_f64" if dtype == torch.float64 else ""
        cases[f"segment_sum{suffix}_{tag}"] = Case(
            tag, *per_step[-1], cfg.n_ds_max)
        cases[f"segment_sum_batched{suffix}_{tag}"] = Case(
            tag, *(torch.stack(t) for t in zip(*per_step)), cfg.n_ds_max)
    return cases


# The adversarial inputs: each generator (seed, numpy dtype) -> numpy
# (cols (N, C), live (N,), seg_id (N,) int64, n_out), N and n_out fixed per
# generator (the batched case stacks seeds); columns from a normal draw
# with some -0.0 (a segment of -0.0 must sum to +0.0).


def _columns(rng, n: int, c: int, dtype) -> np.ndarray:
    cols = rng.normal(0.0, 10.0, (n, c)).astype(dtype)
    cols[rng.uniform(size=n) < 0.05] = -0.0
    return cols


def _dead_tail(ids: np.ndarray, n: int, n_out: int, rng):
    """(live, seg_id): ``ids`` with 90% of their points live, then dead
    points in segment n_out up to n."""
    live = np.zeros(n, dtype=bool)
    live[:len(ids)] = rng.uniform(size=len(ids)) < 0.9
    seg_id = np.full(n, n_out, np.int64)
    seg_id[:len(ids)] = ids
    return live, seg_id


def one_segment(seed: int, dtype) -> tuple:
    """1200 kept points all in segment 0, longer than any block's staged
    tile, then 300 dead; n_out 64 (segments 1..63 empty)."""
    rng = np.random.default_rng(seed)
    live, seg_id = _dead_tail(np.zeros(1200, np.int64), 1500, 64, rng)
    return _columns(rng, 1500, 4, dtype), live, seg_id, 64


def all_dead(seed: int, dtype) -> tuple:
    """1000 points, none live, all in the overflow segment; n_out 64."""
    rng = np.random.default_rng(seed)
    return (_columns(rng, 1000, 4, dtype), np.zeros(1000, dtype=bool),
            np.full(1000, 64, np.int64), 64)


def no_points(seed: int, dtype) -> tuple:
    """N = 0: every one of n_out 64 segments empty."""
    return (np.zeros((0, 4), dtype), np.zeros(0, dtype=bool),
            np.zeros(0, np.int64), 64)


def every_id_kept(seed: int, dtype) -> tuple:
    """k = n_out = 200: segments 0..199 of 1-8 points each (90% live), then
    300 live points past the last kept voxel in the overflow segment, the
    rest of N = 2000 dead."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(200), rng.integers(1, 9, 200))
    live, seg_id = _dead_tail(ids, 2000, 200, rng)
    live[len(ids):len(ids) + 300] = True
    return _columns(rng, 2000, 4, dtype), live, seg_id, 200


def block_edges(seed: int, dtype) -> tuple:
    """Segments of 1, R - 1, R and R + 1 points (R = ``BLOCK_POINTS``)
    drawn at random, so that they straddle the block boundaries at many
    offsets, cut so that the last kept point is a block's last (point
    40 R - 1), then dead points to N = 4096; n_out 40 R, so the empty tail
    is long and the first dead point starts a block."""
    rng = np.random.default_rng(seed)
    kept = 40 * BLOCK_POINTS
    lengths = rng.choice([1, BLOCK_POINTS - 1, BLOCK_POINTS,
                          BLOCK_POINTS + 1], size=kept)
    ids = np.repeat(np.arange(kept), lengths)[:kept]
    live, seg_id = _dead_tail(ids, 4096, kept, rng)
    return _columns(rng, 4096, 4, dtype), live, seg_id, kept


def odd_c3(seed: int, dtype) -> tuple:
    """3 columns (12-byte float32 rows) at N = 1001, so ranges and lanes
    start off 16 bytes: sorted ids drawn from about 70% of 0..96 (empty
    segments between kept ones, live points in the overflow), the last 101
    points dead."""
    rng = np.random.default_rng(seed)
    n_out, n, n_live = 96, 1001, 900
    pool = np.union1d(np.arange(n_out + 1)[rng.uniform(size=n_out + 1) < 0.7],
                      [n_out])
    ids = np.sort(rng.choice(pool, n_live))
    seg_id = np.concatenate([ids, np.full(n - n_live, n_out)]).astype(np.int64)
    return _columns(rng, n, 3, dtype), np.arange(n) < n_live, seg_id, n_out


ADVERSARIAL_CASES = {f.__name__: f for f in (
    one_segment, all_dead, no_points, every_id_kept, block_edges, odd_c3)}


def adversarial_cases(device="cuda", streams: int = STREAMS) -> dict:
    """name -> Case of each adversarial generator, float32 and float64,
    single (``ADVERSARIAL_SEED``) and over ``streams`` lanes (the next
    seeds)."""
    cases = {}
    for dtype, np_dtype in ((torch.float32, np.float32),
                            (torch.float64, np.float64)):
        suffix = "_f64" if dtype == torch.float64 else ""
        for name, gen in ADVERSARIAL_CASES.items():
            lanes = [gen(ADVERSARIAL_SEED + s, np_dtype)
                     for s in range(streams + 1)]
            n_out = lanes[0][3]
            tensors = [tuple(torch.from_numpy(a).to(device) for a in lane[:3])
                       for lane in lanes]
            cases[f"segment_sum{suffix}_{name}"] = Case(
                ADVERSARIAL, *tensors[0], n_out)
            cases[f"segment_sum_batched{suffix}_{name}"] = Case(
                ADVERSARIAL, *(torch.stack(t) for t in zip(*tensors[1:])),
                n_out)
    return cases


def launch(case: Case):
    """The kernel on the case: one single or one batched launch."""
    fn = (seg.segment_mean_cuda_batched if case.batched
          else seg.segment_mean_cuda)
    return fn(case.cols, case.live, case.seg_id, case.n_out)


def plain(case: Case):
    """The plain version on the case's device, lane by lane when
    batched."""
    if not case.batched:
        return seg.segment_mean_plain(case.cols, case.live, case.seg_id,
                                      case.n_out)
    per = [seg.segment_mean_plain(c, m, s, case.n_out)
           for c, m, s in zip(case.cols, case.live, case.seg_id)]
    return tuple(torch.stack(o) for o in zip(*per))


def cpu_plain(case: Case):
    """The plain version on a CPU copy of the case."""
    return plain(Case(case.tag, *(t.cpu() for t in case[1:4]), case.n_out))


def bits_equal(got, want, what: str = "segment_mean") -> float:
    """Raise unless ``got`` (means, mask) is bit for bit ``want`` (on the
    CPU); the means' max |delta|, 0.0."""
    err = 0.0
    for g, w in zip(got, want):
        g = g.cpu()
        if g.shape != w.shape:
            raise RuntimeError(f"{what}: shape {tuple(g.shape)}, not "
                               f"{tuple(w.shape)}")
        if g.dtype != torch.bool and g.numel():
            err = max(err, float((g - w).abs().max()))
        if not torch.equal(g, w):
            raise RuntimeError(f"{what}: differs from its plain version "
                               f"(max {err})")
    return err


def segment_reduce_mean(cols: torch.Tensor, live: torch.Tensor,
                        seg_id: torch.Tensor, n_out: int):
    """The plain version's function through ``torch.segment_reduce``
    (PyTorch's sorted segment reduction): the sums and counts of the
    segments below n_out, cut by offsets that ``searchsorted`` finds on
    the device, then the same division.  Measured beside the kernel, used
    nowhere in the port."""
    w = live.to(cols.dtype)
    offsets = torch.searchsorted(
        seg_id, torch.arange(n_out + 1, device=seg_id.device))
    sums = torch.segment_reduce(cols * w[:, None], "sum", offsets=offsets,
                                unsafe=True)
    cnts = torch.segment_reduce(w, "sum", offsets=offsets, unsafe=True)
    return sums / torch.clamp_min(cnts, 1.0)[:, None], cnts > 0


def segment_reduce_probe(case: Case) -> dict:
    """``segment_reduce_mean`` on a single case on the card: whether it is
    bit-equal to the plain version on a CPU copy (and its max |delta|),
    whether two calls are bit-equal, whether a call reads the host
    (``set_sync_debug_mode("error")``), and, if it does not, its time in a
    CUDA graph of 100 (``graph_us``) or the capture's error."""
    args = (case.cols, case.live, case.seg_id, case.n_out)
    got, again = segment_reduce_mean(*args), segment_reduce_mean(*args)
    want = seg.segment_mean_plain(*(t.cpu() for t in args[:3]), case.n_out)
    torch.cuda.synchronize()
    out = {"bit_equal_to_plain": all(torch.equal(g.cpu(), w)
                                     for g, w in zip(got, want)),
           "max_abs_err": float((got[0].cpu() - want[0]).abs().max()),
           "repeats": all(torch.equal(g, a) for g, a in zip(got, again))}
    torch.cuda.set_sync_debug_mode("error")
    try:
        segment_reduce_mean(*args)
        out["host_sync"] = False
    except RuntimeError as e:
        out["host_sync"] = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if out["host_sync"] is False:
        try:
            out["graph_us"] = graph_us(lambda: segment_reduce_mean(*args))
        except RuntimeError as e:
            out["graph_us"] = None
            out["capture_error"] = str(e).splitlines()[0]
    return out


def segment_lengths(case: Case) -> dict:
    """What the case's kept segments hold, over its lanes: the non-empty
    segments below n_out, the longest and the 99th percentile of their
    lengths (points)."""
    ids = case.seg_id if case.batched else case.seg_id[None]
    lengths = torch.cat([torch.unique_consecutive(
        s[s < case.n_out], return_counts=True)[1].cpu() for s in ids])
    if lengths.numel() == 0:
        return {"segments": 0, "longest": 0, "p99": 0.0}
    return {"segments": int(lengths.numel()), "longest": int(lengths.max()),
            "p99": float(np.percentile(lengths.numpy(), 99))}


def shape(case: Case) -> dict:
    S = case.cols.shape[0] if case.batched else 1
    N, C = case.cols.shape[-2:]
    return dict(S=S, N=N, C=C, n_out=case.n_out, **segment_lengths(case),
                dtype=str(case.cols.dtype).removeprefix("torch."))


def bound_row(case: Case) -> dict:
    """The case's bound (``bounds.segment_mean_bound``) and its three
    terms, us."""
    b = bounds.segment_mean_bound(case.seg_id, case.cols.shape[-1],
                                  case.n_out, case.cols.dtype)
    return {"bound_us": 1e3 * b.ms, "bound_by": b.by,
            "bound_bytes": b.nbytes, "chain_us": b.chain_us,
            "bound_terms_us": {
                "bytes": 1e6 * b.nbytes / bounds.H100_HBM_BYTES_PER_S,
                "operations": 1e6 * b.ops / bounds.FLOPS[case.cols.dtype],
                "chain": b.chain_us}}


def is_segment_kernel(name: str) -> bool:
    return "segment_mean_kernel<" in name


def ptxas(case: Case, usage: dict = None) -> dict:
    """The ptxas usage of the kernel instance the case launches (its type,
    columns and shape: ``Wide`` for a batched case, ``Narrow`` else), from
    ``usage`` (a build log's, by entry) or the default build's."""
    scalar = "d" if case.cols.dtype == torch.float64 else "f"
    kernel = f"segment_mean_kernelI{scalar}Li{case.cols.shape[-1]}E"
    shape = "4Wide" if case.batched else "6Narrow"
    usage = usage or build.kernel_usage("segment_sum")
    mine = [use for name, use in usage.items()
            if kernel in name and shape in name]
    return mine[0] if mine else None


def measure(case: Case, reps: int) -> dict:
    """The case's row: its shape, times, bound and the kernel's
    registers."""
    t = kernel_us(lambda: launch(case), reps, is_segment_kernel)
    return {
        "shape": shape(case),
        "device_us": t["device_us"], "device_timer": t["device_timer"],
        "profiler_windows": t["profiler_windows"],
        "launches_per_call": t["launches_per_call"],
        "graph_us": t["graph_us"],
        "enqueue_us": enqueue_us(lambda: launch(case), reps),
        "plain_us": stream_us(lambda: plain(case), max(5, reps // 5)),
        "library_us": graph_us(lambda: plain(case)),
        **bound_row(case),
        "ptxas": ptxas(case),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50,
                    help="calls per profiler window and enqueue median")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench_segment_sum: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    build.build_all(["segment_sum"])
    for tag in (*RUNS, ADVERSARIAL):
        for name, case in make_cases(tag).items():
            row = {"name": name, "max_abs_err": bits_equal(
                launch(case), cpu_plain(case), name),
                   **measure(case, args.reps)}
            if not case.batched and tag != ADVERSARIAL:
                row["segment_reduce"] = segment_reduce_probe(case)
            print(json.dumps(row), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

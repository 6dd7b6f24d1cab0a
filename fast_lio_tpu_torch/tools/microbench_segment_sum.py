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
(``kernels/bounds.segment_mean_bound``); for the single cases also
``segment_reduce``, what ``segment_reduce_probe`` finds of the same
function through ``torch.segment_reduce``.  Prints one JSON line per case,
then the card's name and power limit.
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
                             registers, stream_us)

STREAMS = 4  # lanes of the batched case: the last STREAMS steps
SCANS = 7  # steps of the sim run (the first one seeds the map)
NUDGE_SEED = 300


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
    ``profile_scan.RUNS`` run) in float32 and float64."""
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


def segments(case: Case) -> int:
    """The case's non-empty segments below n_out, over its lanes."""
    ids = case.seg_id if case.batched else case.seg_id[None]
    return sum(int(torch.unique(s[s < case.n_out]).numel()) for s in ids)


def is_segment_kernel(name: str) -> bool:
    return "segment_mean_kernel<" in name


def measure(case: Case, reps: int) -> dict:
    """The case's row: its shape, times, bound and the kernel's
    registers."""
    S = case.cols.shape[0] if case.batched else 1
    N, C = case.cols.shape[-2:]
    bound = bounds.segment_mean_bound(case.seg_id, C, case.n_out,
                                      case.cols.dtype)
    t = kernel_us(lambda: launch(case), reps, is_segment_kernel)
    scalar = "d" if case.cols.dtype == torch.float64 else "f"
    return {
        "shape": dict(S=S, N=N, C=C, n_out=case.n_out,
                      segments=segments(case),
                      dtype=str(case.cols.dtype).removeprefix("torch.")),
        "device_us": t["device_us"], "device_timer": t["device_timer"],
        "profiler_windows": t["profiler_windows"],
        "launches_per_call": t["launches_per_call"],
        "graph_us": t["graph_us"],
        "enqueue_us": enqueue_us(lambda: launch(case), reps),
        "plain_us": stream_us(lambda: plain(case), max(5, reps // 5)),
        "library_us": graph_us(lambda: plain(case)),
        "bound_us": 1e3 * bound.ms, "bound_by": bound.by,
        "bound_bytes": bound.nbytes,
        "ptxas": registers("segment_sum", "segment_mean_kernel", C, scalar),
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
    for tag in ("avia", "ouster64"):
        for name, case in make_cases(tag).items():
            row = {"name": name, **measure(case, args.reps)}
            if not case.batched:
                row["segment_reduce"] = segment_reduce_probe(case)
            print(json.dumps(row), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

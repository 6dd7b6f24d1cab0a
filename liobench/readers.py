"""What the metric files share: readers of the run's window and its device
spans, its profiled window and its rooflines.  Each returns None where the
run has nothing for it to read (another driver, no device spans or trace,
no kernel of that name)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import roofline, trace
from .reference import sync

KNN_KERNELS = r"knn_\w*kernel<\s*\w+\s*,\s*(\d+)\s*>"
SEGMENT_MEAN_KERNELS = r"segment_mean\w*kernel"


def profiled(ctx: Dict, driver: str) -> Optional[Dict]:
    """The profiled window's trace, where the run is of ``driver`` and the
    profiler saw the device."""
    p = ctx.get("profile")
    if ctx["driver"] != driver or p is None or p["trace"]["busy_s"] is None:
        return None
    return p


def spans(ctx: Dict, driver: str) -> Optional[Tuple[float, float]]:
    """The window's device time and wall time a scan (s), where the run is
    of ``driver`` and its window kept device spans (a traced run on
    CUDA)."""
    w = ctx["window"]
    if ctx["driver"] != driver or not w.get("spans"):
        return None
    return sum(w["spans"]) / w["scans"], w["wall_s"] / w["scans"]


def idle_pct(ctx: Dict, driver: str) -> Optional[float]:
    """The share of the window's wall time in which the card had no scan's
    work under way: 1 - device span / wall time, a scan."""
    got = spans(ctx, driver)
    return None if got is None else 100.0 * (1.0 - got[0] / got[1])


def gap_ms(ctx: Dict, driver: str) -> Optional[float]:
    """The window's wall time less its device spans, a scan, ms: how long
    the card waits between scans for the host."""
    got = spans(ctx, driver)
    return None if got is None else 1e3 * (got[1] - got[0])


def activities(ctx: Dict, driver: str) -> Optional[float]:
    """The profiled window's device activities (kernels and copies) a
    scan."""
    p = profiled(ctx, driver)
    if p is None:
        return None
    return p["trace"]["activities"] / p["scans"]


def knn_pct(ctx: Dict, driver: str, samples: int = 8) -> Optional[float]:
    """The kNN kernels' share of their roofline over the profiled window:
    each R's launches times the mean least time of one launch over the last
    ``samples`` scans, their searched points against the map after the
    window; over the kernels' device time."""
    p = profiled(ctx, driver)
    if p is None:
        return None
    secs, calls, by_r = trace.kernel_time(p["trace"], KNN_KERNELS)
    if not calls or secs <= 0:
        return None
    cfg, packed = ctx["config"], ctx["map_packed"]
    cell = float(cfg["map_cell_multiplier"]) * float(cfg["filter_size_map"])
    h_log2 = int(cfg["map_h_log2"])
    bound = 0.0
    for r, n in by_r.items():
        per = [roofline.knn_work(packed, q, cell, h_log2, int(r) == 27)
               .seconds(packed.dtype) for q in p["queries"][-samples:]]
        bound += n * float(np.mean(per))
    return 100.0 * bound / secs


def downsample_pct(ctx: Dict, driver: str) -> Optional[float]:
    """The segmented mean's share of its roofline over the profiled window:
    each scan's points as the preprocessing keeps them (the reference's
    decoder) into their voxels, over the kernels' device time."""
    p = profiled(ctx, driver)
    if p is None:
        return None
    secs, calls, _ = trace.kernel_time(p["trace"], SEGMENT_MEAN_KERNELS)
    if not calls or secs <= 0:
        return None
    cfg = ctx["config"]
    bound = 0.0
    for msg in p["raw"]:
        pts, _t = sync.decode(msg, cfg)
        pts = torch.as_tensor(pts[:int(cfg["n_points_max"])],
                              device=ctx["device"])
        bound += roofline.segment_mean_work(
            pts, float(cfg["filter_size_surf"]), int(cfg["n_ds_max"])
        ).seconds()
    return 100.0 * bound / secs

"""A cell's run with the port's tracer on (``fast_lio_tpu_torch.tracing``),
and the per-layer metrics that read its spans, counters and stage stamps.

From the root of a checkout, on the card:

    python3 -m liobench.program_trace --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1> --tracer <0|1>

The run is ``harness.run_cell``'s.  With ``--tracer 1`` the tracer is
enabled before the cell's pipeline is built (so its captured graph holds
the eight stage stamps) and dumped three times: after the warm-up (the
set-up's spans, its ``capture`` spans among them), before the window (the
profiled windows' spans and stamps, dropped; its counters are the window's
base) and after the window's drain.  ``--tracer 0`` runs the same cell the
same way with the tracer off: the pair gives what tracing costs.  Prints
the run's result line (``liobench.run``'s, with ``program_metrics``: the
metrics below by name, each with its unit) and then one ``program_trace``
line: the window's gaps between replays summed by the host span under way
when the card finished a replay, the regions' medians a second of the
window, the clock's calibrations, and the checks of the stamps against the
harness's own readings (``consistency``).

The metrics (``METRICS``) read a ``Run``; each returns None where the run
has nothing for it (another kind of run, the tracer off, no stamps, no capture;
the stamps' and the launch counters' readers on the CPU, whose steps
launch no kernel and are stamped on the host's clock):

===============================  =======================================
``graph_ms.replay`` / ``.online``  median over the window's replays of the
                                   last stamp less the first
``graph_gap_ms.replay``            mean of a replay's first stamp less the
                                   one before's last
``imu_ms.replay``                  median ``imu`` region
``map_ms.replay``                  median of ``map_slide`` + ``insert``
``downsample_ms.replay``           median ``downsample`` region
``update_ms.replay``               median ``update`` region
``pack_ms.replay``                 median ``pack`` span
``launch_ms.replay``               median ``launch`` span
``knn_searches_per_scan.replay``   kNN launches of every R in the window
                                   over its scans
``capture_s``                      the set-up's ``capture`` spans, summed
===============================  =======================================
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from fast_lio_tpu_torch import tracing  # noqa: E402

from . import drivers  # noqa: E402

KNN_SEARCHES = ("knn", "knn_f64", "knn_batched", "knn_batched_f64",
                "knn_grouped", "knn_cand", "knn_cand_f64",
                "knn_cand_batched", "knn_cand_batched_f64")


@dataclass
class Run:
    """What a traced cell's run kept: its kind (the mix's ``driver``:
    replay, online), the three dumps, the window's numbers and the
    profiled window's, the graphs' stats."""
    kind: str = ""
    setup: Optional[dict] = None
    before: Optional[dict] = None
    window: Optional[dict] = None
    numbers: Optional[dict] = None  # the window's (``Single.window``)
    profiled: List[dict] = field(default_factory=list)
    graph_stats: Optional[dict] = None


def _on_card(run: Run, kind: str) -> bool:
    return (run.kind == kind and run.window is not None
            and str(run.window["device"]).startswith("cuda"))


def _rows(run: Run, kind: str) -> Optional[np.ndarray]:
    """The window's stamp rows (replays x 8, host-clock ns), where the run
    is of that kind, on the card and stamped."""
    if not _on_card(run, kind) or not run.window["stamps"] or \
            not run.window["stamps"]["t"]:
        return None
    return np.asarray(run.window["stamps"]["t"], np.int64)


def graph_ms(run: Run, kind: str) -> Optional[float]:
    t = _rows(run, kind)
    return None if t is None else 1e-6 * float(np.median(t[:, -1] - t[:, 0]))


def graph_gap_ms(run: Run, kind: str) -> Optional[float]:
    t = _rows(run, kind)
    if t is None or len(t) < 2:
        return None
    return 1e-6 * float(np.mean(t[1:, 0] - t[:-1, -1]))


def region_ms(run: Run, kind: str, names) -> Optional[float]:
    """Median over the replays of the named regions' sum."""
    t = _rows(run, kind)
    if t is None:
        return None
    d = np.diff(t, axis=1)
    idx = [tracing.REGIONS.index(n) for n in names]
    return 1e-6 * float(np.median(d[:, idx].sum(axis=1)))


def span_ms(run: Run, kind: str, name: str) -> Optional[float]:
    """Median duration of the window's spans named ``name``."""
    if run.kind != kind or run.window is None:
        return None
    d = [s["end"] - s["start"] for s in run.window["spans"]
         if s["name"] == name and s["end"] is not None]
    return 1e-6 * statistics.median(d) if d else None


def knn_searches_per_scan(run: Run, kind: str) -> Optional[float]:
    """kNN launches of every R over the window (the launch counters,
    settled at each dump) over its scans."""
    if not _on_card(run, kind) or run.before is None \
            or not run.numbers or not run.numbers["scans"]:
        return None
    a, b = run.before["launches"], run.window["launches"]
    n = sum(b[c][r] - a[c].get(r, 0) for c in KNN_SEARCHES for r in b[c])
    return n / run.numbers["scans"]


def capture_s(run: Run) -> Optional[float]:
    if run.setup is None:
        return None
    caps = [s for s in run.setup["spans"] if s["name"] == "capture"]
    return 1e-9 * sum(s["end"] - s["start"] for s in caps) if caps else None


METRICS: Dict[str, tuple] = {  # name -> (unit, reader)
    "graph_ms.replay": ("ms", lambda r: graph_ms(r, "replay")),
    "graph_gap_ms.replay": ("ms", lambda r: graph_gap_ms(r, "replay")),
    "imu_ms.replay": ("ms", lambda r: region_ms(r, "replay", ("imu",))),
    "map_ms.replay": ("ms", lambda r: region_ms(
        r, "replay", ("map_slide", "insert"))),
    "downsample_ms.replay": ("ms", lambda r: region_ms(
        r, "replay", ("downsample",))),
    "update_ms.replay": ("ms", lambda r: region_ms(r, "replay", ("update",))),
    "pack_ms.replay": ("ms", lambda r: span_ms(r, "replay", "pack")),
    "launch_ms.replay": ("ms", lambda r: span_ms(r, "replay", "launch")),
    "knn_searches_per_scan.replay": (
        "count", lambda r: knn_searches_per_scan(r, "replay")),
    "graph_ms.online": ("ms", lambda r: graph_ms(r, "online")),
    "capture_s": ("s", capture_s),
}


# ---------------------------------------------------------------------------
# what the program trace says beyond the metrics
# ---------------------------------------------------------------------------

def gaps_by_span(run: Run) -> Dict[str, float]:
    """The window's gaps between replays (a replay's first stamp less the
    one before's last, s), summed by the innermost host span under way
    when the card finished the replay before (``no span`` where none)."""
    t = _rows(run, run.kind)
    if t is None or len(t) < 2:
        return {}
    spans = sorted((s for s in run.window["spans"] if s["end"] is not None),
                   key=lambda s: s["start"])
    starts = [s["start"] for s in spans]
    out: Dict[str, float] = defaultdict(float)
    for done, nxt in zip(t[:-1, -1], t[1:, 0]):
        name = "no span"
        for j in range(bisect.bisect_right(starts, done) - 1,
                       max(-1, bisect.bisect_right(starts, done) - 65), -1):
            if spans[j]["end"] >= done:
                name = spans[j]["name"]
                break
        out[name] += 1e-9 * float(nxt - done)
    return dict(out)


def regions_by_second(run: Run) -> List[List[float]]:
    """For each second of the window: [second, replays, the step's median
    ms, then each region's median ms]."""
    t = _rows(run, run.kind)
    if t is None:
        return []
    d = 1e-6 * np.diff(t, axis=1)
    sec = (t[:, 0] - t[0, 0]) // 1_000_000_000
    out = []
    for s in np.unique(sec):
        m = sec == s
        out.append([int(s), int(m.sum()),
                    float(np.median(d[m].sum(axis=1))),
                    *(float(v) for v in np.median(d[m], axis=0))])
    return out


def consistency(run: Run, metrics: Dict[str, float]) -> Dict:
    """The stamps held to the harness's own readings in the same run."""
    from . import readers, trace
    out: Dict = {}
    w = run.numbers
    g, gap = metrics.get(f"graph_ms.{run.kind}"), metrics.get(
        "graph_gap_ms.replay")
    if g is not None and gap is not None and w["scans"]:
        out["stamped_wall_over_wall"] = (1e-3 * (g + gap) * w["scans"]
                                         / w["wall_s"])
        t = _rows(run, run.kind)  # the mean step in place of the median
        out["mean_step_and_gap_over_wall"] = 1e-9 * (
            np.mean(t[:, -1] - t[:, 0]) + 1e6 * gap) * w["scans"] / w["wall_s"]
    if g is not None:
        parts = [metrics.get(k) for k in ("imu_ms.replay", "map_ms.replay",
                                          "downsample_ms.replay",
                                          "update_ms.replay")]
        if None not in parts:
            out["four_stages_over_graph"] = sum(parts) / g
        if w.get("spans"):
            out["graph_over_device_span"] = g / (
                1e3 * statistics.median(w["spans"]))
    k = metrics.get("knn_searches_per_scan.replay")
    if k is not None and run.profiled and "trace" in run.profiled[0]:
        p = run.profiled[0]
        _s, calls, _by = trace.kernel_time(p["trace"], readers.KNN_KERNELS)
        out["knn_over_profiled"] = k / (calls / p["scans"]) if calls else None
    if run.graph_stats is not None:
        out["capture_s_stats"] = sum(v["capture_s"]
                                     for v in run.graph_stats.values())
    out["window_stamped"] = len(run.window["stamps"]["t"]) \
        if run.window and run.window["stamps"] else 0
    out["window_lost"] = run.window["stamps"]["lost"] \
        if run.window and run.window["stamps"] else None
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _traced_class(run: Run, tracer: bool, device) -> Callable:
    class Traced(drivers.Single):
        """The cell's stream (``drivers.Single``), traced: the tracer
        enabled before its pipeline is built, dumped after the warm-up,
        before and after the window."""

        def __init__(self, *a, **kw):
            if tracer:
                tracing.enable(device)
            super().__init__(*a, **kw)
            run.kind = self.mix["driver"]

        def _dump(self):
            return tracing.dump() if tracer else None

        def warm(self):
            super().warm()
            run.setup = self._dump()

        def scans(self, n):
            out = super().scans(n)
            run.profiled.append(out)
            return out

        def window(self, seconds):
            run.before = self._dump()
            out = super().window(seconds)
            run.window = self._dump()
            run.numbers = out
            return out

        def release(self):
            if self.pipe.graphs is not None:
                run.graph_stats = self.pipe.graphs.stats()
            super().release()
    return Traced


def run_traced(workload: str, seed: int, seconds: float, traced: bool,
               tracer: bool, device="cuda", **kw) -> tuple:
    """``harness.run_cell`` with the tracer on (``tracer``) or off; returns
    its result dict and the ``Run``."""
    from . import harness
    run = Run()
    saved = dict(drivers.DRIVERS)
    cls = _traced_class(run, tracer, device)
    drivers.DRIVERS.update({k: cls for k in saved})
    try:
        out = harness.run_cell(workload, seed, seconds, traced, device, **kw)
    finally:
        drivers.DRIVERS.update(saved)
        if tracer:
            tracing.disable()
    return out, run


def summary(run: Run) -> Dict:
    """The ``program_trace`` line's numbers (with the metrics)."""
    metrics = {}
    for name, (unit, read) in METRICS.items():
        v = read(run)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}
    flat = {k: v["value"] for k, v in metrics.items()}
    calib = [d["stamps"]["calibration"] for d in (run.setup, run.before,
                                                   run.window)
             if d and d["stamps"]]
    return dict(program_metrics=metrics,
                gaps_by_span=gaps_by_span(run),
                regions=list(tracing.REGIONS),
                regions_by_second=regions_by_second(run),
                calibrations=calib,
                counters=run.window["counters"] if run.window else None,
                consistency=consistency(run, flat) if run.numbers else None)


def main(argv=None) -> int:
    from . import run as bench_run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    bench_run._caches()
    import torch
    torch.set_num_threads(2)
    if not torch.cuda.is_available():
        print("program_trace: no CUDA card, nothing measured",
              file=sys.stderr)
        return 1
    out, run = run_traced(args.workload, args.seed, args.seconds,
                          bool(args.trace), bool(args.tracer), "cuda",
                          t_start=T_START)
    stderr = out.pop("_stderr")
    out.pop("_parts")
    extra = summary(run)
    out["program_metrics"] = extra.pop("program_metrics")
    out["tracer"] = args.tracer
    checks = out.pop("checks")
    out["checks"] = checks
    print("program_trace " + json.dumps(bench_run._clean(extra)), flush=True)
    print(json.dumps(bench_run._clean(out)), flush=True)
    for line in stderr:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

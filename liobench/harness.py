"""One run of one cell: set-up, warm-up, (traced) profile window, the
measured window, the metrics, the output check.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the path in ``BENCHMARK.json``): the port's
  ``Config`` fields as run, the sensor's model and noise;
* ``mixes/<traffic>.json``: the driver (``replay``, ``online``), the world
  and route, the warm-up, the traced run's windows and the output check's
  chains;
* ``limits/<workload>.json``: the numbers the output check compares in
  this cell, each with its limit;
* ``metrics/<metric>.py``: ``read(ctx)``, the metric's value from what the
  run kept, or None where it finds nothing to read.

Each is looked up first under the ``liobench/`` folder beside the
``BENCHMARK.json`` in use, then in this package.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check, drivers, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_BENCH = ROOT / "BENCHMARK.json"
TUPLES = {"extrinsic_T", "extrinsic_R", "pad_buckets"}
FORBIDDEN = ("jax", "jaxlib", "flax", "fast_lio_tpu")


class Cell:
    """A cell of ``BENCHMARK.json`` with its files.  ``overrides`` replaces
    entries of the configuration's ``config``, its ``assumed.sensor``, the
    mix or the limits (each a dict), for runs at a tiny size on the CPU."""

    def __init__(self, workload: str, bench_path: Path = DEFAULT_BENCH,
                 overrides: Optional[Dict] = None):
        bench_path = Path(bench_path)
        self.root = bench_path.parent
        self.bench = json.loads(bench_path.read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in {bench_path}: "
                           f"{', '.join(cells)}")
        self.workload = cells[workload]
        self.name = workload
        conf = {c["name"]: c for c in self.bench["configs"]}[
            self.workload["config"]]
        self.config_file = json.loads((self.root / conf["file"]).read_text())
        self.mix = self._data("mixes", self.workload["traffic"])
        self.limits = self._data("limits", workload)
        over = overrides or {}
        self.limits.update(over.get("limits", {}))
        self.config = dict(self.config_file["config"], **over.get("config",
                                                                  {}))
        self.sensor = dict(self.config_file["assumed"]["sensor"],
                           **over.get("sensor", {}))
        self.noise = self.config_file["assumed"]["noise"]
        for k, v in over.get("mix", {}).items():
            self.mix[k] = dict(self.mix[k], **v) if isinstance(v, dict) else v
        reports = {m["name"] for m in self.bench["end_to_end"]
                   if self._applies(m, set())}
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if m["name"] in reports]
        self.per_layer = [m for m in self.bench["per_layer"]
                          if self._applies(m, reports)]

    def _applies(self, metric: Dict, reports) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return metric.get("moves") in reports if "moves" in metric else True

    def _search(self, sub: str, name: str, ext: str) -> Path:
        for base in (self.root / "liobench", HERE):
            p = base / sub / f"{name}{ext}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {sub}/{name}{ext} for cell {self.name}")

    def _data(self, sub: str, name: str) -> Dict:
        return json.loads(self._search(sub, name, ".json").read_text())

    def reader(self, metric: str):
        path = self._search("metrics", metric, ".py")
        spec = importlib.util.spec_from_file_location(
            "liobench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def program_config(self):
        """The port's ``Config`` of this cell."""
        from fast_lio_tpu_torch.config import Config, LidarType, TimeUnit
        kw = {}
        for k, v in self.config.items():
            if k == "lidar_type":
                v = LidarType(v)
            elif k == "time_unit":
                v = TimeUnit(v)
            elif k in TUPLES or (k == "epsi" and isinstance(v, list)):
                v = tuple(v)
            kw[k] = v
        return Config(**kw)


class Program:
    """The port's entry points the benchmark drives."""

    def __init__(self):
        from fast_lio_tpu_torch.pipeline import Pipeline
        from fast_lio_tpu_torch.preprocess.drivers import decode
        self.Pipeline = Pipeline
        self.decode = decode


def device_info(device, chips: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's (whole names: the port's name starts with the JAX
    package's)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def log(obj) -> None:
    """An earlier line of the run's standard output."""
    print("liobench " + json.dumps(obj), flush=True)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: Optional[float] = None,
             bench_path: Path = DEFAULT_BENCH,
             overrides: Optional[Dict] = None,
             control: bool = False) -> Dict:
    """One run.  Returns the result line (a dict) and, under
    ``"_stderr"``, the lines for standard error, under ``"_parts"`` the
    check's numbers of the start and of the chains apart; with ``control``
    also the control's numbers (``"_control"``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = Cell(workload, bench_path, overrides)
    chips = int(cell.workload.get("chips", 1))
    kind = cell.mix["driver"]
    if traced:
        trace.open_session(device)
    t_built = time.perf_counter()
    drv = drivers.DRIVERS[kind](cell, Program(), seed, device, traced)
    t_lap = time.perf_counter()
    drv.warm()
    log({"setup": {"imports_s": t_built - t_start,
                   "lap_and_pipeline_s": t_lap - t_built,
                   "warm_s": time.perf_counter() - t_lap,
                   "warm_scans": drv.warm_scans()}})
    drv.plan_chains(seconds)
    profile = None
    if traced:
        log({"card": trace.card_clock(), "when": "before the profile"})
        n = int(cell.mix["profile_scans"])
        profile = trace.profile(lambda: drv.scans(n), device)
        drv.live_queries(profile)
        log({"card": trace.card_clock(), "when": "after the profile"})
        # the idle gaps by what the host did: a shorter window that records
        # the host's ops too, which slow it (its times are not reported)
        labels = trace.profile(lambda: drv.scans(max(1, n // 3)), device,
                               host=True)
        profile["trace"]["idle"] = labels["trace"]["idle"]
    t_window = time.perf_counter()
    window = drv.window(seconds)
    info = device_info(device, chips)
    drv.failed = drv.nonfinite_poses(window["scans"])
    window["passes"] = [int(d.iterations) for d in window.pop("diags")]
    log({"host": {"per_second": window["seconds"], "affinity":
                  sorted(os.sched_getaffinity(0))}})
    packed = drv.map_packed()
    slots = packed.shape[-1] // 4
    log({"map": {"live_points": int((packed[:, 3 * slots:] == 0).sum()),
                 "slots": int(packed.shape[0] * slots),
                 "full_buckets": int((packed[:, 3 * slots:] == 0).all(-1)
                                     .sum()),
                 "buckets": int(packed.shape[0])}})
    ctx = dict(cell=cell, driver=kind, config=cell.config,
               setup_s=t_window - t_start, window=window, profile=profile,
               map_packed=drv.map_packed(), device=device)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = cell.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    del ctx
    drv.release()
    gc.collect()
    t_check = time.perf_counter()
    result = check.compare(cell.config, drv, device)
    log({"check_s": time.perf_counter() - t_check})
    out = {"correct": False, "attempted": drv.attempted,
           "failed": drv.failed, "metrics": metrics, "device": info}
    if traced and profile is not None:
        tr = profile["trace"]
        if tr["busy_s"] is not None:
            out["device"]["busy_s"] = tr["busy_s"]
            out["device"]["window_s"] = tr["wall_s"]
        out["breakdown"] = trace.breakdown(tr)
    numbers, limits = result["numbers"], cell.limits
    ok = (check.verdict(numbers, limits) and drv.failed == 0
          and result["chain_steps"] > 0 and result["start_steps"] > 0)
    out["correct"] = bool(ok)
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    out["checks"]["failed_poses"] = {"value": drv.failed, "limit": 0}
    stderr = [f"liobench: {result['chains']} chains, "
              f"{result['chain_steps']} chain steps and "
              f"{result['start_steps']} start steps compared"]
    stderr += check.lines(numbers, limits)
    stderr.append(f"check failed_poses {drv.failed} limit 0")
    out["_stderr"] = stderr
    out["_parts"] = {k: result[k] for k in ("start", "chain", "passes")}
    if control:
        out["_control"] = check.compare(cell.config, drv, device,
                                        control=True)
    return out


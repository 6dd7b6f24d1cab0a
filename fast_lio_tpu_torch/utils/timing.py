"""Per-scan timing + state logging, schema-compatible with the reference.

Port of ``fast_lio_tpu/utils/timing.py`` (numpy only).  The reference
dumps ``Log/fast_lio_time_log.csv`` at exit with the header
(laserMapping.cpp:1042-1044):

  time_stamp, total time, scan point size, incremental time, search time,
  delete size, delete time, tree size st, tree size end, add point size,
  preprocess time

``CSV_HEADER``, ``ScanTiming``, ``TimingLog`` and ``StateLog`` write files
byte-identical to the JAX package's for the same inputs, so one set of
analysis tools (Log/fast_lio_time_log_analysis.m, Log/plot.py) reads the
logs of both; that includes the CSV's leading ``#`` comment line, kept
verbatim.  In the port the stage columns, when filled
(``--stage-timing``), are run-level CUDA-event means of each stage group
(``utils/stage_timing.py``), flat across rows as the JAX package's are.

Also provides the ``pos_log.txt`` full-state dump writer
(dump_lio_state_to_log, laserMapping.cpp:150-164) in the same column order.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np

CSV_HEADER = (
    "time_stamp, total time, scan point size, incremental time, search time, "
    "delete size, delete time, tree size st, tree size end, add point size, "
    "preprocess time, n_eff"
)

# Kept verbatim from the JAX package so both write the same file.
CSV_COMMENT = (
    "# stage columns (search/incremental/delete) are run-level slope-method "
    "constants, flat across rows (one fused device program has no per-frame "
    "stage brackets); total_time, preprocess_time and n_eff are per-frame"
)


@dataclasses.dataclass
class ScanTiming:
    time_stamp: float = 0.0
    total_time: float = 0.0
    scan_point_size: int = 0
    incremental_time: float = 0.0
    search_time: float = 0.0
    delete_size: int = 0
    delete_time: float = 0.0
    tree_size_st: int = 0
    tree_size_end: int = 0
    add_point_size: int = 0
    preprocess_time: float = 0.0
    n_eff: int = 0  # effective (plane-gate-passing) points in the update


class TimingLog:
    def __init__(self):
        self.rows: List[ScanTiming] = []

    def append(self, row: ScanTiming):
        self.rows.append(row)

    def write_csv(self, path):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            f.write(CSV_COMMENT + "\n")
            f.write(CSV_HEADER + "\n")
            for r in self.rows:
                f.write(
                    f"{r.time_stamp:.8f},{r.total_time:.8f},{r.scan_point_size},"
                    f"{r.incremental_time:.8f},{r.search_time:.8f},"
                    f"{r.delete_size},{r.delete_time:.8f},{r.tree_size_st},"
                    f"{r.tree_size_end},{r.add_point_size},"
                    f"{r.preprocess_time:.8f},{r.n_eff}\n"
                )

    def summary(self) -> dict:
        if not self.rows:
            return {}
        tot = np.array([r.total_time for r in self.rows])
        return {
            "frames": len(self.rows),
            "mean_total_s": float(tot.mean()),
            "p50_total_s": float(np.percentile(tot, 50)),
            "p99_total_s": float(np.percentile(tot, 99)),
            "scan_rate_hz": float(1.0 / max(tot.mean(), 1e-12)),
        }


class StateLog:
    """pos_log.txt writer (laserMapping.cpp:150-164 column order):
    t, rot-log(3), pos(3), omega(3)=0, vel(3), acc(3)=0, bg(3), ba(3), grav(3)."""

    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        self._fh = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "w")

    def append(self, t, rot_log, pos, vel, bg, ba, grav):
        if not self._fh:
            return
        z = "0.000000 0.000000 0.000000"

        def v3(a):
            return f"{a[0]:.6f} {a[1]:.6f} {a[2]:.6f}"

        self._fh.write(
            f"{t:.6f} {v3(rot_log)} {v3(pos)} {z} {v3(vel)} {z} "
            f"{v3(bg)} {v3(ba)} {v3(grav)} \r\n"
        )
        self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

"""The ATE of the pipeline and of the quirk-faithful f64 oracle on one
benchmark scenario.

Runs the same simulated scenario (``tools/scenarios.py``) through (a) the
oracle in reference mode (``oracle.py``, ``quirks=True``: the reference's
exact math with an unbounded brute-force kNN, laserMapping.cpp:638-754)
and (b) the port's pipeline (CUDA by default; the region-limited search
with the wide fallback), and prints both aligned and raw ATE in one JSON
line, the keys of the JAX package's ``tools/oracle_ab.py``.  If the
pipeline's ATE is within about 2x of the oracle's, the gap to ground truth
is the filter's: the reference would do no better on this data.

Run from the repository root:

    python3 -m fast_lio_tpu_torch.tools.oracle_ab [scenario] [duration_s]
        [--device cpu]

scenario: avia, ouster64, mid360 or velodyne_outdoor (default); duration_s
makes a run of that length of the scenario's geometry (default 10 s).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .. import sim
from ..oracle import OracleLIO
from ..pipeline import Pipeline
from . import scenarios
from .oracle_compare import packets_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", nargs="?", default="velodyne_outdoor",
                    choices=scenarios.NAMES)
    ap.add_argument("duration", nargs="?", type=float, default=None,
                    help="seconds of data (default the scenario's 10)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline (default cuda)")
    args = ap.parse_args(argv)
    cfg, data = scenarios.scenario(
        args.scenario, args.duration or scenarios.DURATION_S)
    pkts = packets_of(data, cfg)  # one construction, shared by both runs

    t0 = time.time()
    pipe = Pipeline(cfg, device=args.device)
    for p in pkts:
        pipe.process_packet(p)
    traj_pipe = pipe.get_trajectory()
    t_pipe = time.time() - t0

    # the reference's math, f64, unbounded search
    t0 = time.time()
    orc = OracleLIO(cfg, quirks=True)
    for i, p in enumerate(pkts):
        orc.process_packet(p)
        if i % 20 == 0:
            print(f"  oracle scan {i}/{len(pkts)} (map {orc.map.size()})",
                  file=sys.stderr)
    traj_orc = orc.trajectory
    t_orc = time.time() - t0

    out = {
        "scenario": args.scenario,
        "scans": len(pkts),
        "duration_s": args.duration or float(data.scan_stamps[-1]
                                             - data.scan_stamps[0] + 0.1),
        "pipeline": {
            "ate_aligned_m": round(sim.ate_rmse_aligned(traj_pipe, data), 4),
            "ate_raw_m": round(sim.ate_rmse(traj_pipe, data), 4),
            "wall_s": round(t_pipe, 1),
        },
        "oracle_quirks_f64": {
            "ate_aligned_m": round(sim.ate_rmse_aligned(traj_orc, data), 4),
            "ate_raw_m": round(sim.ate_rmse(traj_orc, data), 4),
            "wall_s": round(t_orc, 1),
            "map_size": int(orc.map.size()),
        },
    }
    out["ratio_aligned"] = round(
        out["pipeline"]["ate_aligned_m"]
        / max(out["oracle_quirks_f64"]["ate_aligned_m"], 1e-9), 2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

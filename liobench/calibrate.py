"""The readings the output check's limits are set from: one cell run on many
seeds in one process, each seed's numbers beside the control's (the
reference in float32 with TF32 matrix products in the program's place).

From the root of a checkout, on a machine with a CUDA card:

    python3 -m liobench.calibrate --workload <name> --seeds 1,2,3 \\
        --seconds 3 [--out chiprun_out/calibrate.jsonl]

Prints one JSON line a seed: ``correct`` against the current limits, the
program's numbers, the control's, and the cell's end-to-end metrics.  The
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .run import _caches, _clean


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, each a run")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    _caches()
    import torch

    from . import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card; nothing run", file=sys.stderr)
        return 1
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds,
                               bool(args.trace), "cuda", control=True)
        ctrl = out.pop("_control")
        parts = out.pop("_parts")
        line = _clean({"workload": args.workload, "seed": seed,
                       "correct": out["correct"],
                       "numbers": {k: v["value"]
                                   for k, v in out["checks"].items()},
                       "control": ctrl["numbers"],
                       "parts": parts,
                       "control_parts": {k: ctrl[k] for k in
                                         ("start", "chain", "passes")},
                       "compared": {k: ctrl[k] for k in
                                    ("chains", "chain_steps", "start_steps")},
                       "metrics": {k: v["value"]
                                   for k, v in out["metrics"].items()},
                       "attempted": out["attempted"],
                       "memory_peak_bytes":
                           out["device"]["memory_peak_bytes"],
                       "run_s": time.perf_counter() - t0})
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark of ``fast_lio_tpu_torch`` on the card.

From the root of a checkout:

    python3 -m liobench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Sets up (imports, the kernels' libraries built or loaded from
``build/fast_lio_tpu_torch/``, the traffic's lap cast, the pipeline built and
warmed up, its graph captured), measures for ``--seconds``, checks the
window's outputs against the plain reference, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics, from a short
profiled window and the window's own spans), ``device`` and, traced,
``breakdown``; then ``checks``, each number compared with its limit, which
are also the last lines on standard error.  It exits 1 without as many CUDA
cards as the cell takes, and 2 if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    few host threads."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "2")


def _clean(v):
    """JSON has no infinity: a number that is not finite prints as null."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    import torch

    torch.set_num_threads(2)
    from . import harness

    chips = int(harness.Cell(args.workload).workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"liobench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available, nothing measured",
              file=sys.stderr)
        return 1
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"liobench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 2
    stderr = out.pop("_stderr")
    out.pop("_parts")
    checks = out.pop("checks")
    out["checks"] = checks  # the last key
    print(json.dumps(_clean(out)), flush=True)
    for line in stderr:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

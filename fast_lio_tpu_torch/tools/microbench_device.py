"""Device time of the primitives the kNN search and the map are built from,
one op at a time, in torch: the region gather from ``packed``, the squared
distances and the top-5 over the candidates, the bucket sort, an
elementwise pass and a scatter.

Run from the repository root (CUDA by default):

    python3 -m fast_lio_tpu_torch.tools.microbench_device [--reps 50]
        [--device cpu]

The port of the JAX package's ``tools/microbench_device.py``, at its shapes
(H = 8192 buckets of B = 64 slots, 4096 queries of 8 region rows, inputs
from ``numpy.random.default_rng(0)``) and with its row names (its "XLA" row
is here the same ops in torch).  Per row, on a card: ``device_ms``, the
device time of one call from ``torch.profiler``'s device activities (all
the op's kernels; the JAX tool's slope of a device loop), and
``enqueue_ms``, the host clock around one call with no synchronize inside
(median): what an eager caller pays to launch it.  On the CPU there is no
device time: ``host_ms`` is the host clock around one call, and
``device_ms`` is null.  Prints one line per row as the JAX tool does, then
one JSON line with every row and, on a card, its name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable

import numpy as np
import torch

from .microbench_knn import card, device_us

H, B, NQ, NR = 8192, 64, 4096, 8
C = NR * B


def per_call(fn: Callable, reps: int, device: torch.device) -> dict:
    """One row of times of ``fn`` (see the module's docstring); ``fn`` is
    called once first to warm up."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        sync()
    host_ms = 1e3 * statistics.median(host)
    if not cuda:
        return {"device_ms": None, "host_ms": host_ms}
    # every device activity of the call counts: the whole op's time
    per_activity_us, _rest, activities = device_us(fn, reps, lambda _: True)
    device_ms = (None if per_activity_us is None
                 else 1e-3 * per_activity_us * activities)
    return {"device_ms": device_ms, "enqueue_ms": host_ms,
            "device_activities": activities}


def print_row(name: str, row: dict, width: int) -> None:
    """The JAX tool's line: ms per call, device time on a card."""
    if row["device_ms"] is None:
        print(f"{name:{width}s} {row['host_ms']:8.3f} ms/iter   (host, no "
              "device)", flush=True)
    else:
        print(f"{name:{width}s} {row['device_ms']:8.3f} ms/iter   (enqueue "
              f"{row['enqueue_ms']:.3f} ms)", flush=True)


def ops(device: torch.device) -> dict:
    """name -> call, on the JAX tool's inputs (the same draws, in order)."""
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)
    packed = torch.tensor(rng.normal(size=(H, 4 * B)), **f32)
    buckets = torch.tensor(rng.integers(0, H, size=(NQ, NR)), device=device)
    q = torch.tensor(rng.normal(size=(NQ, 3)).astype(np.float32) * 3,
                     device=device)
    d2_rand = torch.tensor(rng.random((NQ, C)), **f32)
    flat_idx = (buckets[:, 0] * 7) % (H * 4 * B)
    scratch = packed.reshape(-1).clone()

    def knn_body():
        rows = packed[buckets.reshape(-1)].reshape(NQ, NR, 4 * B)
        cx = rows[:, :, 0 * B:1 * B].reshape(NQ, C)
        cy = rows[:, :, 1 * B:2 * B].reshape(NQ, C)
        cz = rows[:, :, 2 * B:3 * B].reshape(NQ, C)
        cw = rows[:, :, 3 * B:4 * B].reshape(NQ, C)
        d2 = ((cx - q[:, None, 0]) ** 2 + (cy - q[:, None, 1]) ** 2
              + (cz - q[:, None, 2]) ** 2 + cw)
        sq, idx = torch.topk(d2, 5, dim=1, largest=False)
        return sq, torch.take_along_dim(cx, idx, dim=1)

    return {
        "knn XLA (gather+d2+top5+extract)": knn_body,
        "gather 32768 rows 1KB": lambda: packed[buckets.reshape(-1)].sum(),
        "elementwise 2MB r/w": lambda: packed * 1.000001 + 1e-6,
        "sort 32k int32": lambda: torch.sort(
            (buckets.reshape(-1) & (H - 1)).to(torch.int32)),
        "top_k(5) of (4096,512)": lambda: torch.topk(-d2_rand, 5, dim=1),
        "scatter 4096 scalars": lambda: scratch.index_put_(
            (flat_idx,), torch.ones((), **f32)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50,
                    help="calls per profiler window and host-clock median")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("microbench_device: no CUDA device; nothing measured "
              "(--device cpu times the host)", file=sys.stderr)
        return 1
    rows = {}
    for name, fn in ops(device).items():
        rows[name] = per_call(fn, args.reps, device)
        print_row(name, rows[name], 48)
    out: dict = {"tool": "microbench_device", "device": device.type,
                 "reps": args.reps, "rows": rows}
    if device.type == "cuda":
        out["card"] = card()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

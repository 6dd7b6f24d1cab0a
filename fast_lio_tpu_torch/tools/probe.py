"""The card's floors, measured with ``csrc/probe.cu``'s kernels: the least
a kernel node costs in a CUDA graph, and the latency of one dependent add
in float32 and float64.

Run from the repository root on a machine with a CUDA device:

    python3 -m fast_lio_tpu_torch.tools.probe

``chip_smoke.py`` phase 2 prints ``empty_node`` (``empty_node_ms``) beside
the kernel rows, and ``kernels/bounds.py`` states the add latencies that
``add_cycles`` measured as the chain term's constants.  Prints one JSON
line, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys

import torch

from ..kernels import build
from .microbench_knn import card, graph_us

CHAIN_STEPS = 1 << 16  # dependent adds a probe times


@functools.cache
def _lib():
    lib = build.load("probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_empty.argtypes = [p]
    for fn in (lib.probe_add_chain_f32, lib.probe_add_chain_f64):
        fn.argtypes = [p, p, p, i, p]
    for fn in (lib.probe_empty, lib.probe_add_chain_f32,
               lib.probe_add_chain_f64):
        fn.restype = i
    lib.probe_error_string.argtypes = [i]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def _checked(err: int) -> None:
    if err != 0:
        raise RuntimeError("probe kernel launch failed: "
                           f"{_lib().probe_error_string(err).decode()}")


def empty_launch() -> None:
    """One empty one-thread kernel on the current stream."""
    _checked(_lib().probe_empty(torch.cuda.current_stream().cuda_stream))


def empty_node_ms() -> float:
    """One empty kernel's time in a CUDA graph of 100 (``graph_us``), ms:
    the least any launch of the step's graphs costs on this card."""
    return 1e-3 * graph_us(empty_launch)


def add_cycles(dtype: torch.dtype, steps: int = CHAIN_STEPS) -> float:
    """SM cycles per dependent add of ``dtype`` (one thread's chain of
    ``steps`` round-to-nearest adds, timed with ``clock64``)."""
    lib = _lib()
    fn = (lib.probe_add_chain_f64 if dtype == torch.float64
          else lib.probe_add_chain_f32)
    x = torch.tensor([1.0, 2.0**-20], dtype=dtype, device="cuda")
    out = torch.empty(1, dtype=dtype, device="cuda")
    cycles = torch.empty(1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):  # the first launch loads the module
        _checked(fn(x.data_ptr(), out.data_ptr(), cycles.data_ptr(), steps,
                    stream))
    torch.cuda.synchronize()
    return int(cycles.item()) / steps


def measure() -> dict:
    return {"empty_node_ms": empty_node_ms(),
            "add_cycles": {"float32": add_cycles(torch.float32),
                           "float64": add_cycles(torch.float64)},
            "sm_clock_mhz": sm_clock_mhz()}


def sm_clock_mhz() -> str:
    """The SM clock and its maximum as ``nvidia-smi`` reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    print(json.dumps(measure()), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

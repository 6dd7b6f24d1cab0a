"""CUDA-graph conditional (IF) nodes recorded into the step's capture
(``csrc/graph_if.cu``), for ``control_flow.gate``.

``record_if(pred, fn)``, while the current stream is capturing a graph:
the library adds a one-thread kernel that sets a conditional handle from
``pred`` (a one-element bool tensor on the device) and an IF node on that
handle to the capture, and starts capturing the node's body on a stream of
its own; ``fn`` then issues the body's work with that stream as PyTorch's
current stream, and the body's capture ends.  A replay runs the body only
where ``pred`` holds.  PyTorch's own ``CUDAGraph.begin_capture_to_if_node``
does the same where a PyTorch build has it; the card's PyTorch (2.11) does
not, so the port records the node itself.

The body's tensors come from the caching allocator like the rest of the
capture's, so that a replay finds them where the capture put them: the
graph's own pool routes only the allocations of the stream that began the
capture, so each nesting depth of bodies has a body stream and a private
pool of its own (``torch.cuda.MemPool``), kept for the process, and a
body's allocations are routed to its depth's pool.  Those blocks serve
only IF bodies, each in graph order, and replays run one after another on
one stream, so no two of them overlap.

``launches`` counts the IF nodes recorded (the set kernel's launches, which
``kernels.counts`` turns into launches as run); nothing here runs on the
CPU, which has no graphs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, Tuple

import torch

from . import build

launches = {0: 0}  # IF nodes recorded (one set kernel each)

# (device index, depth) -> (body stream, its pool), made at first use
_bodies: Dict[Tuple[int, int], Tuple[torch.cuda.ExternalStream,
                                     "torch.cuda.MemPool"]] = {}
_depth: List[int] = [0]  # nesting depth of the body being captured


@functools.cache
def _lib():
    """The library, built at first use, with its C signatures."""
    lib = build.load("graph_if")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.graph_if_begin.argtypes = [p, p, p]
    lib.graph_if_end.argtypes = [p]
    lib.graph_if_stream_create.argtypes = [ctypes.POINTER(p)]
    for fn in (lib.graph_if_begin, lib.graph_if_end,
               lib.graph_if_stream_create):
        fn.restype = i
    lib.graph_if_error_string.argtypes = [i]
    lib.graph_if_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} failed: {_lib().graph_if_error_string(err).decode()}")


def _body(device: torch.device, depth: int):
    """The body stream and pool of ``depth`` on ``device``."""
    key = (device.index, depth)
    if key not in _bodies:
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            _check(_lib().graph_if_stream_create(ctypes.byref(handle)),
                   "creating an IF body's stream")
            _bodies[key] = (torch.cuda.ExternalStream(handle.value,
                                                      device=device),
                            torch.cuda.MemPool())
    return _bodies[key]


def record_if(pred: torch.Tensor, fn: Callable[[], None]) -> None:
    """Record ``fn``'s work as the body of an IF node on ``pred`` into the
    graph the current stream is capturing (the module's docstring)."""
    device = pred.device
    lib = _lib()
    stream, pool = _body(device, _depth[0])
    outer = torch.cuda.current_stream(device)
    with torch.cuda.device(device):
        _check(lib.graph_if_begin(pred.data_ptr(), outer.cuda_stream,
                                  stream.cuda_stream), "recording an IF node")
    launches[0] += 1
    _depth[0] += 1
    try:
        with torch.cuda.stream(stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(device.index,
                                                             pool.id)
            try:
                fn()
            finally:
                torch._C._cuda_endAllocateToPool(device.index, pool.id)
                torch._C._cuda_releasePool(device.index, pool.id)
    finally:
        _depth[0] -= 1
        with torch.cuda.device(device):
            _check(lib.graph_if_end(stream.cuda_stream),
                   "ending an IF node's body")

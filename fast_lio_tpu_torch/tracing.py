"""The port's tracer: host spans and counters where the work happens, and
stage stamps inside the captured step, all on one clock.

A process-wide switch, off by default::

    from fast_lio_tpu_torch import tracing
    tracing.enable("cuda")   # before the first capture
    ...                      # scans
    torch.cuda.synchronize()
    d = tracing.dump()       # spans, counters, stamps; clears spans and ring

Off, a span's call site costs one flag test (``if tracing.ON``), a stamp's
one inside ``stamp`` (a graph replay runs no Python at all), nothing is
allocated and no library is built or loaded.

**Spans** (``begin``/``end``, ``span`` for cold paths) record a name, a start
and an end, the parent span and the scan's index: the spans of one scan
share it, the ``decode`` and ``sync`` spans that make its packet too (the
index is that of the next ``process_packet``).  They are kept in memory
until ``dump``.  While a ``torch.profiler`` session records, each span is
also a ``record_function("fast_lio.<name>")`` range in its trace.

**Counters** (``counters``, by name) count always, at the same boundaries:
``feed_waits`` (``PinnedFeed.take`` blocked) and ``kernel_builds`` (``nvcc``
ran).  ``dump`` adds the kernels' launch counters (``kernels.counts``,
settled there once).

**Stamps** (``stamp(k)``, k = 0..7) mark the edges of the step's seven
regions (``REGIONS``).  On CUDA each is a one-thread kernel
(``csrc/stamp.cu``) on the current stream that writes the device's
``%globaltimer`` into a ring of ``RING_ROWS`` rows at row (steps so far mod
the rows) and column k; the last stamp of a step advances the step count.
In a capture the launch is a kernel node, so every replay writes a row; a
graph captured while the tracer was off holds no stamps (``enable`` warns).
On the CPU, where the eager step runs synchronously, a stamp reads the host
clock.  Rows that wrap before a ``dump`` are counted (``lost``).

**The clock** is ``time.time_ns()``: the Unix ns clock of
``torch.profiler``'s kineto trace (``trace_start_ns``).  The device's
``%globaltimer`` is mapped onto it by a calibration at ``enable`` and at each
``dump`` (a clock kernel launched between two host reads around a
synchronize, the narrowest of ``CALIBRATIONS`` brackets), each stamp by the
offset interpolated between the two calibrations around it; the dump gives
the offset, its error and the drift (with the drift's error: both
calibrations' errors over the time between them).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler

STAMPS = 8
REGIONS = ("feed", "imu", "map_slide", "downsample", "update", "insert",
           "outputs")  # between stamps k and k + 1
RING_ROWS = 16384  # more steps than a 51-s window and its warm-up
CALIBRATIONS = 16  # clock brackets a calibration tries

ON = False

counters: collections.Counter = collections.Counter()

_device: Optional[torch.device] = None
_spans: List[list] = []  # [name, start, end, parent, scan, attrs]
_open: List[int] = []  # the spans begun and not ended, innermost last
_ranges: Dict[int, object] = {}  # span -> its profiler range
_scan = 0  # the index of the scan under way, or the next one
_captured_off = False  # a step was captured with the tracer off
_warned = False
# (device, rows) -> (ring, step count, clock slots), kept for the process:
# a captured graph's stamp nodes hold their addresses
_buffers: Dict[tuple, tuple] = {}
_ring = None  # (rows, STAMPS) int64: device tensor, or numpy on the CPU
_count = None  # (1,) int64 device tensor: steps stamped (CUDA)
_clock = None  # (CALIBRATIONS,) int64 device tensor (CUDA)
_cpu_steps = 0  # steps stamped on the CPU
_read = 0  # steps already dumped
_calib: Optional[dict] = None  # the last calibration


@functools.cache
def _lib():
    """``csrc/stamp.cu``'s library, built at first use, with its C
    signatures."""
    from .kernels import build
    lib = build.load("stamp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stamp_launch.argtypes = [p, p, i, i, i, i, p]
    lib.stamp_clock.argtypes = [p, p]
    lib.stamp_launch.restype = lib.stamp_clock.restype = i
    lib.stamp_error_string.argtypes = [i]
    lib.stamp_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int) -> None:
    if err != 0:
        raise RuntimeError("stamp kernel launch failed: "
                           f"{_lib().stamp_error_string(err).decode()}")


def enable(device="cuda", rows: int = RING_ROWS) -> None:
    """Turn the tracer on for the steps on ``device``: its stamp ring
    (``rows`` rows; on CUDA the library is built or loaded here) and the
    first calibration.  Call it before the first capture."""
    global ON, _device, _ring, _count, _clock, _read, _calib, _warned
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if _captured_off and not _warned:
        _warned = True
        warnings.warn("tracing enabled after a step was captured with it "
                      "off: that graph holds no stage stamps")
    ON = True  # first, so that the library's build span is kept
    _device = device
    if device.type == "cuda":
        key = (device, rows)
        if key not in _buffers:
            _lib()
            z = functools.partial(torch.zeros, dtype=torch.int64,
                                  device=device)
            _buffers[key] = (z((rows, STAMPS)), z(1), z(CALIBRATIONS))
        _ring, _count, _clock = _buffers[key]
        _read = int(_count.item())
    else:
        _ring = np.zeros((rows, STAMPS), np.int64)
        _read = _cpu_steps
    _calib = _calibrate()


def disable() -> None:
    """Turn the tracer off and drop its spans (graphs captured with it on
    keep writing their stamps)."""
    global ON
    ON = False
    for i in reversed(_open):
        _exit_range(i)
    _spans.clear()
    _open.clear()


def note_capture() -> None:
    """Called at each capture of a step (``StepGraphs``)."""
    global _captured_off
    if not ON:
        _captured_off = True


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def begin(name: str, t0: Optional[int] = None, **attrs) -> int:
    """Open span ``name`` (at host clock ``t0``, now by default) inside the
    innermost open one; returns it for ``end``.  Call only where ``ON``."""
    i = len(_spans)
    _spans.append([name, time.time_ns() if t0 is None else t0, None,
                   _open[-1] if _open else None, _scan, attrs])
    _open.append(i)
    if _profiler._is_profiler_enabled:
        r = _profiler.record_function("fast_lio." + name)
        r.__enter__()
        _ranges[i] = r
    return i


def _exit_range(i: int) -> None:
    r = _ranges.pop(i, None)
    if r is not None:
        r.__exit__(None, None, None)


def end(i: int, t1: Optional[int] = None) -> None:
    """Close span ``i`` (at host clock ``t1``, now by default) and any span
    left open inside it (by an exception)."""
    _spans[i][2] = time.time_ns() if t1 is None else t1
    while i in _open:
        _exit_range(_open.pop())


def end_scan(i: int, t1: Optional[int] = None) -> None:
    """Close a scan's root span; later spans belong to the next scan."""
    global _scan
    end(i, t1)
    _scan += 1


@contextlib.contextmanager
def span(name: str, **attrs):
    """A span around the block, where the tracer is on (for paths off the
    per-scan loop: a generator costs more than a flag test)."""
    if not ON:
        yield
        return
    i = begin(name, **attrs)
    try:
        yield
    finally:
        end(i)


# ---------------------------------------------------------------------------
# stamps and the clock
# ---------------------------------------------------------------------------

def stamp(k: int) -> None:
    """Stamp ``k`` of the step on the traced device (the module's
    docstring); nothing where the tracer is off."""
    if not ON:
        return
    last = k == STAMPS - 1
    if _device.type == "cuda":
        with torch.cuda.device(_device):
            _check(_lib().stamp_launch(
                _ring.data_ptr(), _count.data_ptr(), _ring.shape[0], STAMPS,
                k, int(last), torch.cuda.current_stream().cuda_stream))
    else:
        global _cpu_steps
        _ring[_cpu_steps % _ring.shape[0], k] = time.time_ns()
        _cpu_steps += last


def _calibrate() -> dict:
    """The device clock's offset from the host's (ns): the clock kernel's
    reading against the middle of the narrowest host bracket around it;
    ``error_ns`` is half the bracket.  The CPU's stamps are on the host
    clock."""
    if _device.type != "cuda":
        t = time.time_ns()
        return dict(device_ns=t, offset_ns=0, error_ns=0)
    brackets = []
    with torch.cuda.device(_device):
        stream = torch.cuda.current_stream().cuda_stream
        for j in range(CALIBRATIONS):
            torch.cuda.synchronize()
            h0 = time.time_ns()
            _check(_lib().stamp_clock(_clock.data_ptr() + 8 * j, stream))
            torch.cuda.synchronize()
            brackets.append((h0, time.time_ns()))
        dev = _clock.tolist()
    j = min(range(CALIBRATIONS), key=lambda j: brackets[j][1] - brackets[j][0])
    h0, h1 = brackets[j]
    return dict(device_ns=dev[j], offset_ns=(h0 + h1) // 2 - dev[j],
                error_ns=(h1 - h0 + 1) // 2)


def _read_stamps() -> Optional[dict]:
    """The rows stamped since the last dump, on the host clock, and a new
    calibration."""
    global _read, _calib
    if _ring is None:
        return None
    if _device.type == "cuda":
        torch.cuda.synchronize(_device)
        steps, ring = int(_count.item()), _ring.cpu().numpy()
    else:
        steps, ring = _cpu_steps, _ring
    rows = ring.shape[0]
    first = max(_read, steps - rows)
    raw = ring[np.arange(first, steps) % rows]
    before, after = _calib, _calibrate()
    span_ns = after["device_ns"] - before["device_ns"]
    drift = (after["offset_ns"] - before["offset_ns"]) / span_ns if span_ns \
        else 0.0
    offset = before["offset_ns"] + drift * (raw - before["device_ns"])
    errors = before["error_ns"] + after["error_ns"]
    out = dict(regions=list(REGIONS), first=first, lost=first - _read,
               t=(raw + np.rint(offset).astype(np.int64)).tolist(),
               calibration=dict(
                   offset_ns=after["offset_ns"], error_ns=after["error_ns"],
                   previous_error_ns=before["error_ns"],
                   drift_ns_per_s=1e9 * drift,
                   drift_error_ns_per_s=1e9 * errors / span_ns if span_ns
                   else 0.0))
    _read, _calib = steps, after
    return out


# ---------------------------------------------------------------------------
# the dump
# ---------------------------------------------------------------------------

def dump() -> dict:
    """Everything since the last dump, after a drain and outside any span:
    ``spans`` (dicts: name, start, end, parent (an index in the list, or
    None), scan, and the span's attributes), ``counters`` (cumulative),
    ``launches`` (the kernels' launch counters, settled: cumulative, by
    counter and key) and ``stamps`` (``t``: a row of ``STAMPS`` host-clock ns
    a step, ``first`` its step index, ``lost`` the rows that wrapped, and
    the ``calibration``; None where the tracer was never enabled).  Clears
    the spans and the ring."""
    if _open:
        raise RuntimeError(f"tracing.dump() inside {len(_open)} open spans")
    from .kernels import counts
    counts.settle()
    spans = [dict(a, name=n, start=s, end=e, parent=p, scan=k)
             for n, s, e, p, k, a in _spans]
    _spans.clear()
    return dict(clock="unix_ns", device=None if _device is None
                else str(_device), spans=spans, counters=dict(counters),
                launches=counts.named(), stamps=_read_stamps())

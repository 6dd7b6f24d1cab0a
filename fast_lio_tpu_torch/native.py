"""ctypes bindings for the native host runtime (native/lio_host.cpp).

Port of ``fast_lio_tpu/native.py``: the same C functions of the same
``native/liblio_host.so`` at the repository root (host C++ for the
per-point decode loops, not a device kernel).  Loads the library when
present (``make -C native``), attempts an on-the-fly build if a compiler is
available, and otherwise reports unavailable so callers fall back to the
numpy decoders in fast_lio_tpu_torch.preprocess.drivers (identical
semantics, slower).
"""
from __future__ import annotations

import ctypes
import functools
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SO = _NATIVE_DIR / "liblio_host.so"


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    """The library with its C signatures, or None; tried once."""
    if not _SO.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")

    lib.decode_avia.restype = ctypes.c_int
    lib.decode_avia.argtypes = [
        f32p, f32p, i64p, u8p, u8p,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        f32p, f64p, f32p,
    ]
    lib.decode_generic.restype = ctypes.c_int
    lib.decode_generic.argtypes = [
        f32p, f32p, f64p, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, f32p, f64p, f32p,
    ]
    lib.voxel_downsample.restype = ctypes.c_int
    lib.voxel_downsample.argtypes = [f32p, ctypes.c_int, ctypes.c_double, f32p]
    lib.decode_velodyne.restype = ctypes.c_int
    lib.decode_velodyne.argtypes = [
        f32p, f32p, f64p, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int,
        f32p, f64p, f32p,
    ]
    return lib


def available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable ({_SO})")
    return lib


def decode_avia(xyz, reflectivity, offset_ns, tag, line, n_scans, blind,
                point_filter_num):
    """Native Livox decode; same semantics as drivers.decode_avia."""
    lib = _lib()
    n = len(xyz)
    xyz = np.ascontiguousarray(xyz, np.float32)
    refl = np.ascontiguousarray(reflectivity, np.float32)
    ons = np.ascontiguousarray(offset_ns, np.int64)
    tag = np.ascontiguousarray(tag, np.uint8)
    line = np.ascontiguousarray(line, np.uint8)
    out_xyz = np.empty((n, 3), np.float32)
    out_t = np.empty(n, np.float64)
    out_i = np.empty(n, np.float32)
    k = lib.decode_avia(xyz, refl, ons, tag, line, n, n_scans, blind,
                        point_filter_num, out_xyz, out_t, out_i)
    return out_xyz[:k], out_t[:k], out_i[:k]


def decode_generic(xyz, intensity, t_raw, blind, point_filter_num,
                   time_scale_to_s):
    lib = _lib()
    n = len(xyz)
    xyz = np.ascontiguousarray(xyz, np.float32)
    inten = np.ascontiguousarray(intensity, np.float32)
    tr = np.ascontiguousarray(t_raw, np.float64)
    out_xyz = np.empty((n, 3), np.float32)
    out_t = np.empty(n, np.float64)
    out_i = np.empty(n, np.float32)
    k = lib.decode_generic(xyz, inten, tr, n, blind, point_filter_num,
                           time_scale_to_s, out_xyz, out_t, out_i)
    return out_xyz[:k], out_t[:k], out_i[:k]


def decode_velodyne(xyz, intensity, time_raw, ring, scan_rate, to_ms, blind,
                    point_filter_num):
    """Native Velodyne decode incl. azimuth-unwrap reconstruction; same
    semantics as drivers.decode_velodyne (has-time detection is
    ``time_raw[-1] > 0``, preprocess.cpp:304)."""
    lib = _lib()
    n = len(xyz)
    xyz = np.ascontiguousarray(xyz, np.float32)
    inten = np.ascontiguousarray(intensity, np.float32)
    tr = np.ascontiguousarray(time_raw, np.float64)
    rg = np.ascontiguousarray(ring, np.int32)
    has_time = 1 if (n and tr[-1] > 0) else 0
    out_xyz = np.empty((n, 3), np.float32)
    out_t = np.empty(n, np.float64)
    out_i = np.empty(n, np.float32)
    k = lib.decode_velodyne(xyz, inten, tr, rg, n, has_time, scan_rate,
                            to_ms, blind, point_filter_num,
                            out_xyz, out_t, out_i)
    return out_xyz[:k], out_t[:k], out_i[:k]


def voxel_downsample(xyz, leaf):
    lib = _lib()
    xyz = np.ascontiguousarray(xyz, np.float32)
    out = np.empty_like(xyz)
    k = lib.voxel_downsample(xyz, len(xyz), leaf, out)
    return out[:k]

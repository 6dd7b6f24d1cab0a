"""A raw stream's scans as FAST-LIO2's preprocessing keeps them
(preprocess.cpp), and its packets as FAST-LIO2 pairs them (sync_packages,
laserMapping.cpp:368-424): a scan ends at its stamp plus its last point's
time, and takes every IMU sample after the last scan's end up to its own,
with the last sample before that end in front."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


AVIA, OUSTER = 1, 3  # FAST-LIO2's lidar types
NS_TO_S = 1e-9


def decode(msg, cfg) -> Tuple[np.ndarray, np.ndarray]:
    """A driver's message as the configuration's preprocessing keeps it:
    (points (n, 3) float32 in the LiDAR frame, their times (n,) in s from
    the stamp).

    Livox (avia_handler, preprocess.cpp:92-187, features off): from the
    second point on, the returns of a line below ``n_scans`` whose tag is
    0x10 or 0x00, every ``point_filter_num``-th of those, kept where the
    point differs from the message's previous one by more than 1e-7 m and
    lies beyond ``blind``.  Ouster (oust64_handler, :189-282): every
    ``point_filter_num``-th point of the cloud not nearer than ``blind``,
    its time ``t`` in ns."""
    xyz = np.asarray(msg["xyz"], np.float32)
    r2 = (xyz.astype(np.float64) ** 2).sum(1)
    blind2 = float(cfg["blind"]) ** 2
    every = int(cfg["point_filter_num"])
    kind = int(cfg["lidar_type"])
    if kind == AVIA:
        tag = np.asarray(msg["tag"]) & 0x30
        ok = (np.asarray(msg["line"]) < int(cfg["n_scans"])) & (
            (tag == 0x10) | (tag == 0x00))
        ok[0] = False
        ok &= np.cumsum(ok) % every == 0
        moved = np.zeros(len(xyz), bool)
        moved[1:] = np.abs(xyz[1:] - xyz[:-1]).max(1) > 1e-7
        keep = ok & moved & (r2 > blind2)
        t = np.asarray(msg["offset_time_ns"], np.float64)[keep] * NS_TO_S
    elif kind == OUSTER:
        keep = (np.arange(len(xyz)) % every == 0) & (r2 >= blind2)
        t = np.asarray(msg["t"], np.float64)[keep] * NS_TO_S
    else:
        raise ValueError(f"no decoder for lidar type {kind}")
    return xyz[keep], t


@dataclasses.dataclass
class Packet:
    lidar_beg_time: float
    lidar_end_time: float
    pts: np.ndarray
    pt_time: np.ndarray
    imu_t: np.ndarray
    imu_acc: np.ndarray
    imu_gyr: np.ndarray


def packets(scans: Sequence, imu_t: np.ndarray, imu_acc: np.ndarray,
            imu_gyr: np.ndarray, prev_end: Optional[float] = None
            ) -> List[Packet]:
    """The packets of ``scans`` ((stamp, points, times) each, in order)
    from the IMU samples ``imu_t`` (sorted), ``imu_acc``, ``imu_gyr``;
    ``prev_end`` is the end of the scan before the first (None at the start
    of a stream)."""
    out = []
    for stamp, pts, times in scans:
        end = float(stamp) + float(times[-1])
        sel = imu_t <= end + 0.0
        if prev_end is not None:
            sel &= imu_t > prev_end
            before = np.nonzero(imu_t <= prev_end)[0]
            if len(before):
                sel[before[-1]] = True
        idx = np.nonzero(sel)[0]
        out.append(Packet(float(stamp), end, pts, times,
                          np.asarray(imu_t[idx], np.float64),
                          np.asarray(imu_acc[idx], np.float64),
                          np.asarray(imu_gyr[idx], np.float64)))
        prev_end = end
    return out

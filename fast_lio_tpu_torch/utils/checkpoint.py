"""Estimator + map checkpoints, and PCD export.

Port of ``fast_lio_tpu/utils/checkpoint.py`` with the same npz layout, so a
checkpoint written by either package resumes in the other: that is how a
run's state is carried across.  ``save``/``load`` hold the estimator state,
covariance, map and IMU carry; ``save_pipeline``/``load_pipeline`` add the
local-map cube, the sync statistics (``SyncBuffer``'s mean scan time, scan
count, tail IMU sample, last timestamps), the truncation count and the IMU
static-init statistics, so a resume is exact.  In-flight sensor queues
(samples pushed but not yet consumed) belong to the transport and are not
saved, as in the JAX package.

A sharded pipeline (``Pipeline(cfg, group=...)``) writes the global map
layout of the JAX package's mesh: ``save_pipeline`` all-gathers the ranks'
tables (``sharding.gather_global_map``: rank order, ``map_dropped`` of shape
(n,)) on every rank, and each rank writes the path it is given;
``load_pipeline`` keeps the rank's own rows.  The keys are the same, so a
checkpoint of the JAX package's n-device mesh resumes on n ranks of the port
and the other way round.  A checkpoint of another map layout (sharded
against single, or another rank count) is refused.

The reference's only persistence is optional world-scan PCD accumulation
(laserMapping.cpp:1024-1031): ``save_pcd``, ``load_pcd`` and
``PcdAccumulator``, numpy only, write the same files as the JAX package.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import imu as imu_mod
from .. import state as st
from ..map import hash_map as hm


def _to_host(v: torch.Tensor) -> np.ndarray:
    return v.detach().cpu().numpy()


def save(path, x: st.State, P, m: hm.Map, imu_carry: imu_mod.ImuCarry,
         meta: dict = None):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrs = {
        "pos": x.pos, "rot": x.rot, "offset_R_L_I": x.offset_R_L_I,
        "offset_T_L_I": x.offset_T_L_I, "vel": x.vel, "bg": x.bg,
        "ba": x.ba, "grav": x.grav, "P": P,
        "map_packed": m.packed, "map_dropped": m.dropped,
        "angvel_last": imu_carry.angvel_last,
        "acc_s_last": imu_carry.acc_s_last,
    }
    arrs = {k: _to_host(v) for k, v in arrs.items()}
    if meta:
        for k, v in meta.items():
            arrs[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrs)


def load(path, dtype=None, device=None):
    """(x, P, map, imu_carry, meta) as tensors on ``device``; floats cast
    to ``dtype`` (a torch dtype) when given."""
    z = np.load(path)

    def t(a):
        a = np.asarray(a)
        out = torch.from_numpy(a.copy()).to(device)
        return out if dtype is None or a.dtype == bool else out.to(dtype)

    def get(k):
        return t(z[k])

    x = st.State(
        pos=get("pos"), rot=get("rot"), offset_R_L_I=get("offset_R_L_I"),
        offset_T_L_I=get("offset_T_L_I"), vel=get("vel"), bg=get("bg"),
        ba=get("ba"), grav=get("grav"),
    )
    P = get("P")
    dropped = torch.from_numpy(np.asarray(z["map_dropped"]).copy()).to(device)
    if "map_packed" in z.files:
        m = hm.Map(packed=get("map_packed"), dropped=dropped)
    else:  # pre-round-2 checkpoint layout (pts/valid arrays)
        pts = np.asarray(z["map_pts"])
        ok = np.asarray(z["map_valid"])
        w = np.where(ok, 0.0, hm.W_FREE).astype(pts.dtype)
        packed = np.concatenate(
            [pts[..., 0], pts[..., 1], pts[..., 2], w], axis=-1
        )
        m = hm.Map(packed=t(packed), dropped=dropped)
    carry = imu_mod.ImuCarry(get("angvel_last"), get("acc_s_last"))
    meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    return x, P, m, carry, meta


def local_map(pipe, packed, dropped) -> hm.Map:
    """The part of a saved map (``packed``, ``dropped``: tensors or arrays)
    that ``pipe`` holds: all of it, or with a group the rank's rows of the
    global layout.  Raises ValueError on a map of another shape or layout
    (a sharded map's ``dropped`` has one counter per rank, a single map's
    none)."""
    # arrays are copied: they may be read-only (np.load, a JAX array)
    packed, dropped = (a if isinstance(a, torch.Tensor)
                       else torch.from_numpy(np.array(a))
                       for a in (packed, dropped))
    group = pipe.group
    if group is None:
        if dropped.dim() != 0:
            raise ValueError(
                f"the checkpoint's map is sharded {dropped.numel()} ways; "
                "this pipeline holds a single map")
        m = hm.Map(packed=packed, dropped=dropped)
    else:
        from ..parallel import sharding

        m = sharding.split_global_map(packed, dropped, group.rank, group.world)
    if tuple(m.packed.shape) != tuple(pipe.map.packed.shape):
        raise ValueError(
            f"checkpoint map {tuple(m.packed.shape)} != the pipeline's "
            f"{tuple(pipe.map.packed.shape)} (map_h_log2 / bucket slots)")
    return m


def save_pipeline(path, pipe):
    """Complete pipeline checkpoint: estimator, map, IMU carry, local-map
    cube, sync statistics and init bookkeeping.  With a group, a collective
    (every rank writes the global map to its own ``path``)."""
    m = pipe.map
    if pipe.group is not None:
        from ..parallel import sharding

        m = sharding.gather_global_map(m, pipe.group)
    lm_lo, lm_hi, lm_init = pipe.lm_state
    meta = {
        "acc_scale": pipe.acc_scale,
        "imu_need_init": pipe.imu_need_init,
        "map_built": pipe.map_built,
        "first_lidar_time": (np.nan if pipe.first_lidar_time is None
                             else pipe.first_lidar_time),
        "last_lidar_end_time": pipe.last_lidar_end_time,
        "mean_scantime": pipe.sync.mean_scantime,
        "scan_num": pipe.sync.scan_num,
        # tail IMU sample prepended to the next packet (v_imu.push_front
        # analog): without it the first post-resume IMU chain differs
        "sync_last_imu": (np.full(7, np.nan) if pipe.sync.last_imu is None
                          else np.concatenate([[pipe.sync.last_imu[0]],
                                               pipe.sync.last_imu[1],
                                               pipe.sync.last_imu[2]])),
        "sync_last_t_lidar": pipe.sync.last_timestamp_lidar,
        "sync_last_t_imu": pipe.sync.last_timestamp_imu,
        "truncated_points": pipe.truncated_points,
        "lm_lo": _to_host(lm_lo),
        "lm_hi": _to_host(lm_hi),
        "lm_init": bool(lm_init),
        "imu_stats_n": pipe.imu_stats.n,
        "imu_stats_mean_acc": pipe.imu_stats.mean_acc,
        "imu_stats_mean_gyr": pipe.imu_stats.mean_gyr,
        "imu_stats_cov_acc": pipe.imu_stats.cov_acc,
        "imu_stats_cov_gyr": pipe.imu_stats.cov_gyr,
    }
    save(path, pipe.x, pipe.P, m, pipe.imu_carry, meta=meta)


def load_pipeline(path, pipe):
    """Restore a pipeline saved by ``save_pipeline`` (either package's) in
    place, on the pipeline's device and dtype; a sharded pipeline takes its
    rank's rows of the global layout.  Returns the meta dict."""
    x, P, m, carry, meta = load(path, pipe.dtype, pipe.device)
    m = local_map(pipe, m.packed, m.dropped)
    pipe.load_state(x=x, P=P, map=m, imu_carry=carry)
    if "lm_lo" in meta:  # full checkpoint
        pipe.load_state(lm_state=tuple(torch.as_tensor(np.asarray(meta[k]))
                                       for k in ("lm_lo", "lm_hi", "lm_init")))
        pipe.acc_scale = float(meta["acc_scale"])
        pipe.imu_need_init = bool(meta["imu_need_init"])
        pipe.map_built = bool(meta["map_built"])
        flt = float(meta["first_lidar_time"])
        pipe.first_lidar_time = None if np.isnan(flt) else flt
        pipe.last_lidar_end_time = float(meta["last_lidar_end_time"])
        pipe.sync.mean_scantime = float(meta["mean_scantime"])
        pipe.sync.scan_num = int(meta["scan_num"])
        if "sync_last_imu" in meta:
            sli = np.asarray(meta["sync_last_imu"], np.float64)
            pipe.sync.last_imu = (None if np.isnan(sli[0])
                                  else (float(sli[0]), sli[1:4], sli[4:7]))
            pipe.sync.last_timestamp_lidar = float(meta["sync_last_t_lidar"])
            pipe.sync.last_timestamp_imu = float(meta["sync_last_t_imu"])
        pipe.truncated_points = int(meta["truncated_points"])
        pipe.imu_stats = imu_mod.InitStats(
            n=int(meta["imu_stats_n"]),
            mean_acc=np.asarray(meta["imu_stats_mean_acc"]),
            mean_gyr=np.asarray(meta["imu_stats_mean_gyr"]),
            cov_acc=np.asarray(meta["imu_stats_cov_acc"]),
            cov_gyr=np.asarray(meta["imu_stats_cov_gyr"]),
        )
    else:  # pre-round-2 partial checkpoint: best-effort (documented)
        pipe.imu_need_init = False
        pipe.map_built = True
        pipe.acc_scale = float(meta.get("acc_scale", 1.0))
    return meta


def save_pcd(path, pts: np.ndarray, intensity: np.ndarray = None):
    """Minimal binary PCD writer (scans.pcd parity, laserMapping.cpp:1026-1030).

    With ``intensity`` the file carries XYZI like the reference's
    PointCloudXYZI; without it, plain XYZ."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pts = np.asarray(pts, np.float32)
    if intensity is not None:
        cols = np.concatenate(
            [pts, np.asarray(intensity, np.float32)[:, None]], axis=-1)
        fields = ("FIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
                  "COUNT 1 1 1 1\n")
    else:
        cols = pts
        fields = "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        f"VERSION 0.7\n{fields}"
        f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {len(pts)}\nDATA binary\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(cols.tobytes())


class PcdAccumulator:
    """The reference's scans.pcd semantics (laserMapping.cpp:504-529,
    1024-1031): accumulate the DENSE world-frame cloud of every scan
    (pcl_wait_save); with ``save_interval > 0`` the accumulation is flushed
    to ``scans_<idx>.pcd`` every interval scans (pcd_save_interval chunking)
    and the remainder goes to ``scans.pcd`` at shutdown.  This is a
    different artifact from the voxel-downsampled live map export."""

    def __init__(self, out_dir, save_interval: int = -1):
        self.out_dir = Path(out_dir)
        self.save_interval = save_interval
        self.pts = []
        self.intensity = []
        self.scan_wait_num = 0
        self.pcd_index = 0
        self.written = []
        self.total_points = 0

    def add(self, pts: np.ndarray, intensity: np.ndarray = None):
        self.pts.append(np.asarray(pts, np.float32))
        self.intensity.append(
            np.zeros(len(pts), np.float32) if intensity is None
            else np.asarray(intensity, np.float32))
        self.total_points += len(pts)
        self.scan_wait_num += 1
        if (self.total_points > 0 and self.save_interval > 0
                and self.scan_wait_num >= self.save_interval):
            self.pcd_index += 1
            self._flush(self.out_dir / f"scans_{self.pcd_index}.pcd")

    def _flush(self, path):
        save_pcd(path, np.concatenate(self.pts) if self.pts
                 else np.zeros((0, 3), np.float32),
                 np.concatenate(self.intensity) if self.intensity
                 else np.zeros(0, np.float32))
        self.written.append(str(path))
        self.pts, self.intensity, self.scan_wait_num = [], [], 0

    def finish(self):
        """Shutdown save of whatever is still accumulated (scans.pcd)."""
        if self.pts:
            self._flush(self.out_dir / "scans.pcd")
        return list(self.written)


def load_pcd(path) -> np.ndarray:
    """Reads the x/y/z columns of a binary or ascii PCD file."""
    raw = Path(path).read_bytes()
    head_end = raw.find(b"DATA")
    header = raw[:head_end].decode()
    fields, sizes, types, counts, n_pts = [], [], [], [], 0
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "FIELDS":
            fields = parts[1:]
        elif parts[0] == "SIZE":
            sizes = [int(v) for v in parts[1:]]
        elif parts[0] == "TYPE":
            types = parts[1:]
        elif parts[0] == "COUNT":
            counts = [int(v) for v in parts[1:]]
        elif parts[0] == "POINTS":
            n_pts = int(parts[1])
    data_line_end = raw.find(b"\n", head_end) + 1
    mode = raw[head_end:data_line_end].split()[1]
    np_types = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1", ("U", 2): "u2",
                ("U", 4): "u4", ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4"}
    dtype = np.dtype([
        (f, np_types[(t, s)], (c,)) if c > 1 else (f, np_types[(t, s)])
        for f, s, t, c in zip(fields, sizes, types, counts)
    ])
    if mode == b"binary":
        arr = np.frombuffer(raw[data_line_end:], dtype=dtype, count=n_pts)
    else:
        arr = np.loadtxt(raw[data_line_end:].decode().splitlines(),
                         dtype=np.float64)
        return arr[:, :3].astype(np.float32)
    return np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(np.float32)

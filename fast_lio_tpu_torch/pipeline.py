"""The LIO pipeline: host orchestration around the per-scan step.

Port of ``fast_lio_tpu/pipeline.py`` (the reference node's main loop,
laserMapping.cpp:865-1019):

  host: sensor buffering + packet sync (sync_packages analog) + IMU static
        init + padding/bucketing
  device: IMU propagate + deskew -> local-map cube slide + prune -> voxel
        downsample -> iterated point-to-plane iEKF update -> map insert,
        all at fixed shapes

The step reads nothing on the host: every data-dependent choice of the JAX
package's jitted step (``lax.cond``, ``lax.while_loop``) is a
``control_flow.gate`` on a device flag, ``mode="drop"`` scatters write to a
dump row, and the scan's counts and flags reach it as scalars of one feed
buffer.  So on CUDA ``Pipeline`` captures the step in one CUDA graph per pad
bucket (``step_graph.StepGraphs``, the counterpart of ``jax.jit``'s one
compile per input shape) and replays it for every scan, each gate a
CUDA-graph IF node that runs its arm only where JAX's would run;
``Pipeline(graphs=False)`` runs the same step eagerly (the counterpart of
``jax.disable_jit()``), and the CPU always does, with every arm run and
picked by ``torch.where`` (the masked form, which JAX's own ``vmap`` of a
``lax.cond`` is too).  The step from the feed buffer is ``packed_step``, which
``batch.BatchPipeline`` runs under ``torch.func.vmap`` for B streams.  Two host reads remain, as in the JAX package: once during
startup, whether the first scan seeded the map, and with
``Config.stage_timing`` the wait for each scan's outputs.

With the map sharded across ranks (``Pipeline(cfg, group=...)``,
``parallel/sharding.py``) the step is the same sync-free program with the
ranks' collectives in it; every rank runs every pass and every arm (the
masked form, never gated), so the ranks enter the same collectives in the
same order.  On NCCL ranks it is
captured the same way, one graph per pad bucket on every rank, with the
collectives inside (the counterpart of ``jax.jit(shard_map(...))``); gloo
ranks run it eagerly, since gloo's collectives copy through the host and no
graph can record them.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import control_flow as cf
from . import imu as imu_mod
from . import state as st
from .config import Config, LidarType
from .filter import ekf, process
from .kernels import knn as knn_kernel
from .kernels import knn_grouped
from .map import hash_map as hm
from .math import so3
from .ops import measurement as meas
from .ops.voxel_grid import voxel_downsample
from .parallel import sharding
from .step_graph import PinnedFeed, StepGraphs, captures_by_default

MOV_THRESHOLD = 1.5  # laserMapping.cpp:78

KNN_BACKENDS = ("auto", "xla", "grouped")


def _check_knn_backend(cfg: Config):
    if cfg.knn_backend not in KNN_BACKENDS:
        raise ValueError(
            f"knn_backend={cfg.knn_backend!r}: the search backends are "
            "'auto' (= 'xla', the per-query CUDA kNN kernel) and 'grouped' "
            "(the region-grouped CUDA kernel); plain PyTorch on CPU")
    if (cfg.knn_backend == "grouped"
            and cfg.n_ds_max > knn_grouped.PREP_MAX_QUERIES):
        # every search of a scan holds at most n_ds_max queries
        raise ValueError(
            f"knn_backend='grouped' with n_ds_max={cfg.n_ds_max}: its prep "
            f"kernel groups at most {knn_grouped.PREP_MAX_QUERIES} queries "
            "(one block); use the default backend")
    if cfg.knn_backend == "grouped" and cfg.compute_dtype != "float32":
        # the JAX package has no grouped backend to follow in float64
        raise ValueError(
            f"knn_backend='grouped' with compute_dtype={cfg.compute_dtype!r}:"
            " the grouped kernels search in float32 only; use the default "
            "backend, whose per-query kernel searches in float64 too")
    if cfg.rescore_research:
        if cfg.knn_wide_fallback:
            # the cached-candidate rescore re-ranks the 2x2x2 block only
            raise ValueError(
                "rescore_research does not compose with knn_wide_fallback: "
                "the cached candidate block never covers the wide 3x3x3 "
                "region — disable one of the two")
        if cfg.knn_backend == "grouped":
            raise ValueError(
                "rescore_research does not compose with knn_backend="
                "'grouped': the grouped kernel materialises no candidate "
                "block to re-rank")


def make_knn_fn(cfg: Config, map_cfg: hm.MapConfig, m: hm.Map):
    """(queries (N,3), mask (N,)) -> (nbrs, sq, found) against map ``m``.

    The search is ``kernels.knn.knn_search`` (``knn_backend`` "auto" or
    "xla") or ``kernels.knn_grouped.knn_search`` ("grouped"): the CUDA
    kernel on CUDA tensors, its plain version on CPU tensors.  With
    ``Config.knn_wide_fallback``, queries left unsaturated by the 2x2x2
    search (fewer than 5 neighbors, or the 5th beyond the guaranteed
    coverage radius cell_size/2) take the rows of the centered 3x3x3 search,
    or every row does when more than ``knn_wide_max_queries`` are
    unsaturated (``wide_fallback``: the wide search gated on an
    unsaturated query, no host read).

    With ``Config.rescore_research`` the function instead returns the plain
    search with its candidate block, ``(nbrs, sq, found, cand_pts,
    cand_ok)``, on the CPU and on CUDA alike (the JAX package computes it in
    XLA too); ``lio_step`` re-ranks that block in later iterations.
    """
    _check_knn_backend(cfg)
    if cfg.rescore_research:
        return lambda q, mask: hm.knn_search(m, map_cfg, q,
                                             return_candidates=True)
    search = (knn_grouped.knn_search if cfg.knn_backend == "grouped"
              else knn_kernel.knn_search)

    def base(q, wide=False):
        return search(m, map_cfg, q, wide=wide)

    if not cfg.knn_wide_fallback:
        return lambda q, mask: base(q)

    rcov2 = (0.5 * map_cfg.cell_size) ** 2
    K_w = cfg.knn_wide_max_queries
    return lambda q, mask: wide_fallback(base, q, mask, rcov2, K_w)


def wide_fallback(base, queries: torch.Tensor, mask: torch.Tensor,
                  rcov2: float, K_w: int):
    """The adaptive wide-region fallback with no host read: JAX's
    ``make_knn_fn`` fallback (``fast_lio_tpu/pipeline.py:92-125``), its
    ``lax.cond(n_unsat > 0, ...)`` a ``control_flow.gate``.

    ``base(q, wide=False) -> (nbrs, sq, found)`` is the search (the sharded
    step passes its merged search).  The live queries (``mask``) that the
    2x2x2 search leaves unsaturated (fewer than 5 neighbours, or the 5th
    beyond the coverage radius, ``sq > rcov2``) take the centred 3x3x3
    search's rows; when more than ``K_w`` are, every row takes them (with
    ``K_w`` 0 or at least N, which JAX never compacts, as soon as one query
    is unsaturated).  The wide search and the row pick are the gate's body,
    on the narrow search's results as its carry: in the single pipeline's
    captured step an IF node runs them only when a query is unsaturated,
    as JAX's ``lax.cond`` does; in the masked form they run on every call,
    and with no unsaturated query they pick the narrow rows anyway.  JAX
    re-searches only the unsaturated queries, compacted into K_w slots,
    when there are at most K_w of them; a query's search does not depend on
    the other queries of the batch, so those rows are the full wide
    search's rows, and one full wide search serves both of JAX's wide
    arms."""
    N = queries.shape[0]
    narrow = base(queries)
    nbrs, sq, found = narrow
    unsat = (~found[:, -1] | (sq[:, -1] > rcov2)) & mask
    n_unsat = torch.sum(unsat)

    def widen(rows):
        every = n_unsat > (K_w if K_w and K_w < N else 0)
        pick = unsat | every
        wide = base(queries, wide=True)
        return tuple(torch.where(pick.view((N,) + (1,) * (a.dim() - 1)), a, b)
                     for a, b in zip(wide, rows))

    return cf.gate(n_unsat > 0, widen, narrow)


@dataclasses.dataclass
class ScanPacket:
    """A synced measurement packet (MeasureGroup, common_lib.h:55-66)."""

    lidar_beg_time: float
    lidar_end_time: float
    pts: np.ndarray  # (n, 3) f32, LiDAR frame
    pt_time: np.ndarray  # (n,) seconds, offset from lidar_beg_time
    imu_t: np.ndarray  # (m,) absolute seconds
    imu_acc: np.ndarray  # (m, 3)
    imu_gyr: np.ndarray  # (m, 3)
    intensity: Optional[np.ndarray] = None  # (n,) f32
    preprocess_time: float = 0.0  # host decode seconds for this scan


class SyncBuffer:
    """sync_packages (laserMapping.cpp:368-424): pair one LiDAR scan with all
    IMU messages up to the scan-end time, with the mean-scantime fallback for
    degenerate scans.  Host-only; the same code as the JAX package."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.lidar_buf: List[Tuple] = []
        self.imu_t: List[float] = []
        self.imu_acc: List[np.ndarray] = []
        self.imu_gyr: List[np.ndarray] = []
        self.mean_scantime = 0.0
        self.scan_num = 0
        self.last_timestamp_lidar = -np.inf
        self.last_timestamp_imu = -np.inf
        self.last_imu: Optional[Tuple[float, np.ndarray, np.ndarray]] = None
        # soft time sync (laserMapping.cpp:300-324,343-347)
        self.timediff_lidar_wrt_imu = 0.0
        self.timediff_set = False

    def push_lidar(self, stamp: float, pts: np.ndarray, pt_time: np.ndarray,
                   intensity: Optional[np.ndarray] = None,
                   preprocess_time: float = 0.0):
        if stamp < self.last_timestamp_lidar:  # loop-back clear (:284-288)
            self.lidar_buf.clear()
        self.last_timestamp_lidar = stamp
        if (self.cfg.time_sync_en and not self.timediff_set
                and abs(stamp - self.last_timestamp_imu) > 1
                and np.isfinite(self.last_timestamp_imu) and self.imu_t):
            # one-shot clock-offset estimate (laserMapping.cpp:319-324)
            self.timediff_set = True
            self.timediff_lidar_wrt_imu = stamp + 0.1 - self.last_timestamp_imu
        self.lidar_buf.append((stamp, pts, pt_time, intensity, preprocess_time))

    def push_imu(self, t: float, acc: np.ndarray, gyr: np.ndarray):
        t = t - self.cfg.time_offset_lidar_to_imu
        if abs(self.timediff_lidar_wrt_imu) > 0.1 and self.cfg.time_sync_en:
            t = t + self.timediff_lidar_wrt_imu  # (laserMapping.cpp:343-347)
        if t < self.last_timestamp_imu:  # loop-back clear (:353-357)
            self.imu_t.clear()
            self.imu_acc.clear()
            self.imu_gyr.clear()
        self.last_timestamp_imu = t
        self.imu_t.append(t)
        self.imu_acc.append(np.asarray(acc, np.float64))
        self.imu_gyr.append(np.asarray(gyr, np.float64))

    def pop_packet(self) -> Optional[ScanPacket]:
        if not self.lidar_buf or not self.imu_t:
            return None
        stamp, pts, pt_time, intensity, pre_t = self.lidar_buf[0]
        if len(pts) <= 1:
            end = stamp + self.mean_scantime
        elif pt_time[-1] < 0.5 * self.mean_scantime:
            end = stamp + self.mean_scantime
        else:
            self.scan_num += 1
            end = stamp + pt_time[-1]
            self.mean_scantime += (pt_time[-1] - self.mean_scantime) / self.scan_num
        if self.cfg.lidar_type == LidarType.MARSIM:
            end = stamp
        if self.last_timestamp_imu < end:
            return None  # wait for IMU to catch up

        # IMU block: previous tail sample + all samples <= scan end
        take = 0
        while take < len(self.imu_t) and self.imu_t[take] <= end:
            take += 1
        sel_t = self.imu_t[:take]
        sel_a = self.imu_acc[:take]
        sel_g = self.imu_gyr[:take]
        if self.last_imu is not None:
            sel_t = [self.last_imu[0]] + sel_t
            sel_a = [self.last_imu[1]] + sel_a
            sel_g = [self.last_imu[2]] + sel_g
        if take:
            self.last_imu = (self.imu_t[take - 1], self.imu_acc[take - 1],
                             self.imu_gyr[take - 1])
        del self.imu_t[:take], self.imu_acc[:take], self.imu_gyr[:take]
        self.lidar_buf.pop(0)
        return ScanPacket(
            lidar_beg_time=stamp,
            lidar_end_time=end,
            pts=pts,
            pt_time=pt_time,
            imu_t=np.asarray(sel_t),
            imu_acc=np.stack(sel_a) if sel_a else np.zeros((0, 3)),
            imu_gyr=np.stack(sel_g) if sel_g else np.zeros((0, 3)),
            intensity=intensity,
            preprocess_time=pre_t,
        )


@dataclasses.dataclass
class StepDiag:
    """Per-scan diagnostics (the runtime_pos_log fields).  Device-produced
    counts are held as device scalars (``int()`` reads them)."""

    n_raw: int = 0
    n_truncated: int = 0
    n_down: object = 0
    n_effective: object = 0
    iterations: object = 0
    map_size: object = 0
    total_time: float = 0.0
    preprocess_time: float = 0.0


@functools.lru_cache(maxsize=None)
def _fov_constants(cube_side_length: float, det_range: float,
                   dtype: torch.dtype, device: torch.device):
    """The cube's side and the detection range as () tensors in the state
    dtype, rounded as the JAX package rounds them; made once per value,
    dtype and device (no host-to-device copy may run inside a CUDA graph).
    Read-only."""
    return (torch.tensor(cube_side_length, dtype=dtype, device=device),
            torch.tensor(det_range, dtype=dtype, device=device))


def fov_segment(cfg: Config, pos_lid, lm_lo, lm_hi, lm_init):
    """lasermap_fov_segment (laserMapping.cpp:231-277) on device: slide the
    local-map cube when the LiDAR nears a face."""
    cube, det = _fov_constants(cfg.cube_side_length, cfg.det_range,
                               pos_lid.dtype, pos_lid.device)
    half = cube / 2.0
    init_lo = pos_lid - half
    init_hi = pos_lid + half
    d_lo = torch.abs(pos_lid - lm_lo)
    d_hi = torch.abs(pos_lid - lm_hi)
    thr = MOV_THRESHOLD * det
    mov = torch.maximum((cube - 2.0 * MOV_THRESHOLD * det) * 0.5 * 0.9,
                        det * (MOV_THRESHOLD - 1.0))
    zero = torch.zeros_like(d_lo)
    shift = torch.where(d_lo <= thr, -mov, torch.where(d_hi <= thr, mov, zero))
    new_lo = torch.where(lm_init, lm_lo + shift, init_lo)
    new_hi = torch.where(lm_init, lm_hi + shift, init_hi)
    return new_lo, new_hi, torch.ones((), dtype=torch.bool, device=pos_lid.device)


def lio_step(
    cfg: Config,
    map_cfg: hm.MapConfig,
    x: st.State,
    P,
    m: hm.Map,
    imu_carry: imu_mod.ImuCarry,
    Q,
    imu_t_rel,
    imu_acc,
    imu_gyr,
    imu_mask,
    acc_scale,
    last_end_rel,
    pcl_end_rel,
    pts,
    pt_time,
    pt_mask,
    pt_intensity,
    lm_lo,
    lm_hi,
    lm_init,
    ekf_inited: torch.Tensor,
    do_update: torch.Tensor,
):
    """One full per-scan LIO step: IMU propagate + deskew -> local-map cube
    slide + prune -> voxel downsample -> iterated point-to-plane iEKF update
    -> map insert.  Returns (x, P, map, imu_carry, (lm_lo, lm_hi, lm_init),
    clouds, diag).  The map is updated in place.

    ``ekf_inited`` and ``do_update`` are () bool tensors.  The update is
    ``control_flow.gate(do_update, ...)`` (JAX's ``lax.cond`` between
    ``run_update`` and ``skip_update``), as are the prune, the passes, the
    re-searches and the wide search inside it.  Nothing here reads the
    device on the host."""
    deskew = cfg.lidar_type != LidarType.MARSIM

    # 1. IMU propagate + deskew
    x, P, pts_d, imu_carry = imu_mod.propagate_and_deskew(
        x, P, Q, imu_t_rel, imu_acc, imu_gyr, imu_mask, acc_scale,
        last_end_rel, pcl_end_rel, imu_carry, pts, pt_time, deskew=deskew,
    )

    # 2. local-map slide; the prune gated on `moved` (JAX's lax.cond), no
    # host read
    pos_lid = x.pos + so3.quat_rotate(x.rot, x.offset_T_L_I)
    new_lo, new_hi, lm_init2 = fov_segment(cfg, pos_lid, lm_lo, lm_hi, lm_init)
    moved = torch.any(new_lo != lm_lo) | ~lm_init
    lm_lo, lm_hi, lm_init = new_lo, new_hi, lm_init2
    m = hm.prune_outside(m, lm_lo, lm_hi, active=moved)

    # 3. input voxel downsample (intensity voxel-averaged alongside)
    pts_ds, ds_mask, int_ds = voxel_downsample(
        pts_d, pt_mask, cfg.filter_size_surf, cfg.n_ds_max, feats=pt_intensity,
        coord_bound=cfg.det_range * 1.25 + 5.0,  # body frame + deskew margin
    )

    # 4. iterated point-to-plane update
    cache0 = meas.empty_cache(cfg.n_ds_max, pts_ds.dtype, pts_ds.device)
    knn_fn = make_knn_fn(cfg, map_cfg, m)
    if cfg.rescore_research:
        # one map gather per scan: the full search runs here at the
        # predicted pose (what the loop's first iteration would search), and
        # every re-search in the loop re-ranks its candidate block
        cand_pts, cand_ok = knn_fn(meas.body_to_world(x, pts_ds), ds_mask)[3:]
        knn_fn = lambda q, mask: hm.rescore_candidates(
            cand_pts, cand_ok, q, meas.NUM_MATCH)

    def h_fn(x_i, converge, cache):
        h_x, h, sel, cache, valid, _pw = meas.compute_measurement(
            x_i, pts_ds, ds_mask, knn_fn, cache, converge, cfg.extrinsic_est_en)
        return ekf.MeasOut(h_x, h, sel, valid, cache)

    def run_update(c):
        x_u, P_u, cache_u, _ = c
        res = ekf.update_iterated(x_u, P_u, h_fn, cache_u,
                                  cfg.laser_point_cov, cfg.max_iteration,
                                  cfg.epsi)
        return res.x, res.P, res.carry, res.iterations

    # JAX's lax.cond(do_update, run_update, skip_update): the skip arm keeps
    # x, P and the empty cache, with no iteration
    iters0 = torch.zeros((), dtype=torch.int32, device=pts_ds.device)
    x, P, cache, iters = cf.gate(do_update, run_update,
                                 cf.own((x, P, cache0, iters0)))
    n_eff = torch.sum(cache.selected)

    # 5. map insert with hysteresis
    pts_world = meas.body_to_world(x, pts_ds)
    add_mask, ds_flag = hm.insert_decisions(
        pts_world, ds_mask, cache.nbrs, cache.found, ekf_inited,
        cfg.filter_size_map)
    m = hm.insert(m, map_cfg, pts_world, add_mask, ds_flag)

    diag = dict(n_down=torch.sum(ds_mask), n_eff=n_eff, iters=iters,
                map_size=hm.map_size(m))
    clouds = dict(
        world=pts_world, world_mask=ds_mask,  # /cloud_registered (downsampled)
        world_intensity=int_ds,
        body=pts_d, body_mask=pt_mask,  # /cloud_registered_body (dense)
        body_intensity=pt_intensity,
        effect_mask=cache.selected,  # /cloud_effected (world[effect_mask])
    )
    return x, P, m, imu_carry, (lm_lo, lm_hi, lm_init), clouds, diag


def pack_buf(cfg: Config, acc_scale: float, pkt: ScanPacket, last_end_rel,
             pcl_end_rel, ekf_inited, do_update, n_max=None, out=None):
    """One flat f32 feed buffer: [scalars(8) | imu(M,7) | pts(N*3) |
    time(N) | intensity(N)], the JAX package's layout, so every input is
    rounded to f32 exactly as there.  Scalars: acc_scale, last_end_rel,
    pcl_end_rel, n_pts, n_imu, ekf_inited, do_update, 0.  Written into
    ``out`` (a host array of the buffer's length) when given, else into
    a fresh array."""
    if n_max is None:
        n_max = cfg.n_points_max
    m_max = cfg.n_imu_max
    n = min(len(pkt.pts), n_max)
    m = min(len(pkt.imu_t), m_max)
    size = 8 + m_max * 7 + n_max * 5
    if out is None:
        buf = np.zeros(size, np.float32)
    else:
        buf = out
        buf.fill(0.0)
    buf[0:8] = (acc_scale, last_end_rel, pcl_end_rel, n, m,
                1.0 if ekf_inited else 0.0, 1.0 if do_update else 0.0,
                0.0)
    imu = buf[8:8 + m_max * 7].reshape(m_max, 7)
    imu[:m, 0] = pkt.imu_t[:m] - pkt.lidar_beg_time
    imu[:m, 1:4] = pkt.imu_acc[:m]
    imu[:m, 4:7] = pkt.imu_gyr[:m]
    o = 8 + m_max * 7
    pts = np.ascontiguousarray(pkt.pts[:n], np.float32)
    buf[o:o + n * 3] = pts.reshape(-1)
    buf[o + n_max * 3:o + n_max * 3 + n] = pkt.pt_time[:n]
    if pkt.intensity is not None:
        buf[o + n_max * 4:o + n_max * 4 + n] = pkt.intensity[:n]
    return buf


def pad_for(pad_buckets, n: int) -> int:
    """Smallest of the pads ``pad_buckets`` >= n (the largest if none fits;
    the overflow is counted, never silent)."""
    pads = [p for p in pad_buckets if p >= n]
    return min(pads) if pads else max(pad_buckets)


def unpack_feed(cfg: Config, buf: torch.Tensor):
    """The step's inputs from one flat feed buffer (``pack_buf``'s
    layout; the JAX package's ``packed``, ``fast_lio_tpu/pipeline.py:541-564``):
    ``((imu_t, imu_acc, imu_gyr, imu_mask, acc_scale, last_end_rel,
    pcl_end_rel, pts, pt_time, pt_mask, pt_intensity), ekf_inited,
    do_update)``.  The masks are rebuilt on the device from the counts in
    scalars 3-4 and the flags read from scalars 5-6, so no value of the scan
    is a host constant of the program."""
    M = cfg.n_imu_max
    N = (buf.shape[0] - 8 - M * 7) // 5
    dev = buf.device
    scalars = buf[:8]
    imu = buf[8:8 + M * 7].reshape(M, 7)
    o = 8 + M * 7
    pts = buf[o:o + N * 3].reshape(N, 3)
    pt_time = buf[o + N * 3:o + N * 4]
    pt_int = buf[o + N * 4:o + N * 5]
    pt_mask = torch.arange(N, device=dev) < scalars[3].to(torch.int32)
    imu_mask = torch.arange(M, device=dev) < scalars[4].to(torch.int32)
    imu_t = torch.where(imu_mask, imu[:, 0], torch.full_like(imu[:, 0], 1e9))
    return ((imu_t, imu[:, 1:4], imu[:, 4:7], imu_mask,
             scalars[0], scalars[1], scalars[2], pts, pt_time, pt_mask, pt_int),
            scalars[5] > 0.5, scalars[6] > 0.5)


def step_outputs(step) -> tuple:
    """``lio_step``'s results as ``(x, P, map, imu_carry, lm_state, out)``,
    ``out`` the scan's outputs: ``pose`` (7,) = [pos | quat], ``diag`` (4,)
    int64 = [n_down, n_eff, iterations, map_size], and the clouds."""
    x, P, m, imu_carry, lm_state, clouds, d = step
    diag = torch.stack([d[k].to(torch.int64).reshape(()) for k in
                        ("n_down", "n_eff", "iters", "map_size")])
    keep = ("world", "world_mask", "world_intensity", "body", "body_mask",
            "body_intensity")
    out = dict(pose=torch.cat([x.pos, x.rot]), diag=diag,
               **{k: clouds[k] for k in keep})
    return x, P, m, imu_carry, lm_state, out


def packed_step(cfg: Config, map_cfg: hm.MapConfig, x: st.State, P,
                m: hm.Map, imu_carry: imu_mod.ImuCarry, Q, buf: torch.Tensor,
                lm_lo, lm_hi, lm_init) -> tuple:
    """One scan from the flat feed buffer: ``lio_step`` on
    ``unpack_feed(buf)``, the counterpart of the JAX package's ``packed``.
    Returns ``step_outputs``'s ``(x, P, map, imu_carry, lm_state, out)``; the
    map is updated in place.  A pure function of its arguments but for that
    map, with no host read: ``Pipeline`` runs (and captures) it on its
    state, and ``BatchPipeline`` runs it under ``torch.func.vmap`` on B
    states stacked on a leading axis."""
    scan, ekf_inited, do_update = unpack_feed(cfg, buf)
    return step_outputs(lio_step(cfg, map_cfg, x, P, m, imu_carry, Q, *scan,
                                 lm_lo, lm_hi, lm_init, ekf_inited, do_update))


class Pipeline:
    """End-to-end odometry: feed packets, read poses.

    ``device`` defaults to ``"cuda"``; without CUDA the constructor raises
    unless the caller passes ``device="cpu"`` explicitly.

    ``graphs``: on CUDA (the default None) the step is captured in a CUDA
    graph at the first scan of each pad bucket and replayed for every later
    one (``step_graph.StepGraphs``), its gates recorded as IF nodes, so a
    replay runs the update passes, re-searches, wide search, prune and
    update that JAX's step runs and skips the rest; ``graphs=False`` runs
    the same step eagerly with every arm masked, the counterpart of
    ``jax.disable_jit()``.  The CPU never
    captures (``graphs=True`` there raises), nor do gloo ranks (``graphs=
    True`` with a gloo group raises); NCCL ranks do, each its own graph
    with the collectives inside (``step_graph.captures_by_default``).  A
    capture that fails raises; nothing falls back to the eager step.

    ``group`` (a ``parallel.ShardGroup``, from ``init_distributed``) shards
    the map across the group's ranks, on the group's device: the counterpart
    of the JAX package's ``Pipeline(cfg, mesh)``.  Every rank builds its own
    ``Pipeline`` and is fed the same packets; each scan runs
    ``sharding.sharded_lio_step``, with the update on every scan as in the
    JAX sharded path (on the first, empty map it finds no point and changes
    nothing).  ``health_check``, ``measure_stage_times`` and the
    checkpoints are collectives: every rank calls them.  The sharding's
    ablation flags (``sharding.ABLATE_*``) are read when the step is
    captured: a change of them needs a fresh ``Pipeline``.

    The estimator state (``x``, ``P``, ``map``, ``imu_carry``, ``lm_state``)
    lives in tensors the pipeline owns for its life: each scan writes into
    them in place, and ``load_state`` copies a state in.  What a scan keeps
    (trajectory poses, ``state_log``, the ``last_pts_*`` clouds, ``diags``)
    is a copy made on the device, so a later scan never changes it.
    """

    def __init__(self, cfg: Config, device=None, group=None, graphs=None):
        if group is not None:
            if cfg.rescore_research:
                # candidate blocks are per rank; re-ranking them across ranks
                # would need an (N, C, 3) all-gather per iteration
                raise NotImplementedError(
                    "rescore_research is not supported with a sharded map; "
                    "use the default re-search mode")
            if device is not None:
                raise ValueError("a sharded pipeline runs on its group's "
                                 "device; pass no device")
            device = group.device
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Pipeline runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain CPU path")
        if graphs is None:
            graphs = captures_by_default(device, group)
        elif graphs and group is not None and not group.capturable:
            raise ValueError(
                f"graphs=True with a {group.backend} group: its collectives "
                "copy through the host, which a CUDA graph cannot record; "
                "gloo ranks run the step eagerly (NCCL ranks capture it)")
        elif graphs and device.type != "cuda":
            raise ValueError("graphs=True: CUDA graphs need a CUDA device; "
                             "the CPU runs the step eagerly")
        _check_knn_backend(cfg)
        self.cfg = cfg
        self.device = device
        self.group = group
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.map_cfg = hm.make_config(
            voxel_size=cfg.filter_size_map,
            h_log2=cfg.map_h_log2,
            bucket_slots=cfg.map_bucket_slots,
            cell_multiplier=cfg.map_cell_multiplier,
        )
        if self.map_cfg.h_log2 > 15:
            raise ValueError(
                f"map_h_log2={cfg.map_h_log2}: the insert key layout "
                "requires map_h_log2 <= 15")
        self.sync = SyncBuffer(cfg)

        dt, dev = self.dtype, device
        self.x = st.identity_state(dt, dev)
        self.P = torch.eye(st.DOF, dtype=dt, device=dev)
        self.Q = process.process_noise_cov(
            cfg.gyr_cov, cfg.acc_cov, cfg.b_gyr_cov, cfg.b_acc_cov, dt, dev)
        if group is None:
            self.map = hm.make_map(self.map_cfg, dt, dev)
        else:
            self.map = sharding.make_sharded_map(self.map_cfg, group, dt)
        self.imu_carry = imu_mod.init_imu_carry(dt, dev)
        self.lm_state = (torch.zeros(3, dtype=dt, device=dev),
                         torch.zeros(3, dtype=dt, device=dev),
                         torch.zeros((), dtype=torch.bool, device=dev))

        self.pad_buckets = tuple(sorted(set(
            cfg.pad_buckets or (cfg.n_points_max,))))
        self.truncated_points = 0
        self._warned_truncation = False
        # the scan's feed buffer: pinned host memory on CUDA
        self.feed = PinnedFeed() if device.type == "cuda" else None
        # alone, the captured step is gated (IF nodes); sharded, masked
        self.graphs = (StepGraphs(device, group, gates=group is None)
                       if graphs else None)

        # host state
        self.imu_stats = imu_mod.empty_stats()
        self.imu_need_init = True
        self.acc_scale = 1.0
        self.first_lidar_time: Optional[float] = None
        self.last_lidar_end_time = 0.0
        self.map_built = False
        # (stamp, pos, quat) with device tensors; get_trajectory() reads them
        self.trajectory: List[Tuple[float, torch.Tensor, torch.Tensor]] = []
        self.state_log: List[Tuple[float, st.State]] = []  # runtime_pos_log
        self.diags: List[StepDiag] = []
        self.last_pts_world = None
        self.last_pts_world_mask = None
        self.last_pts_world_intensity = None
        self.last_pts_body = None
        self.last_pts_body_mask = None
        self.last_pts_body_intensity = None

    def load_state(self, x: st.State = None, P: torch.Tensor = None,
                   map: hm.Map = None, imu_carry: imu_mod.ImuCarry = None,
                   lm_state: tuple = None) -> None:
        """Copy the given parts of the estimator state into the pipeline's
        own tensors, in place, in their dtype and on their device.  Every
        write of the state goes through here (IMU init, the JAX handover in
        ``convert``, a checkpoint resume, and each scan's step): a captured
        step reads and writes those tensors, so rebinding them would leave
        it on stale memory.  Raises ValueError on a shape that differs."""
        pairs = []
        if x is not None:
            pairs += zip(self.x, x)
        if P is not None:
            pairs.append((self.P, P))
        if map is not None:
            pairs += [(self.map.packed, map.packed),
                      (self.map.dropped, map.dropped)]
        if imu_carry is not None:
            pairs += zip(self.imu_carry, imu_carry)
        if lm_state is not None:
            pairs += zip(self.lm_state, lm_state)
        for dst, src in pairs:
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"state of shape {tuple(src.shape)} loaded "
                                 f"into {tuple(dst.shape)}")
            dst.copy_(src)

    def _pad_for(self, n: int) -> int:
        """Smallest configured pad >= n (largest if none fits; the overflow
        is counted, never silent — see process_packet)."""
        return pad_for(self.pad_buckets, n)

    # ------------------------------------------------------------------
    # the step on the device
    # ------------------------------------------------------------------

    def _packed_step(self, buf: torch.Tensor) -> dict:
        """One scan from the flat feed buffer (``pack_buf``'s layout),
        ``packed_step`` on the pipeline's state; the new state is written
        into the pipeline's tensors (``load_state``).  Returns the scan's
        outputs (``packed_step``'s).  Reads nothing on the host, so
        ``StepGraphs`` captures it."""
        state = (self.x, self.P, self.map, self.imu_carry)
        if self.group is None:
            *new, out = packed_step(self.cfg, self.map_cfg, *state, self.Q,
                                    buf, *self.lm_state)
        else:  # the sharded step updates on every scan, as JAX's does
            scan, ekf_inited, _ = unpack_feed(self.cfg, buf)
            step = sharding.sharded_lio_step(
                self.cfg, self.map_cfg, self.group, *state, self.Q, *scan,
                *self.lm_state, ekf_inited)
            *new, out = step_outputs(step)
        self.load_state(*new)
        return out

    # ------------------------------------------------------------------
    # host orchestration
    # ------------------------------------------------------------------

    def get_trajectory(self):
        """Trajectory on the host: [(t, pos np(3,), quat np(4,)), ...]."""
        return [
            (t, p.detach().cpu().numpy().astype(np.float64),
             q.detach().cpu().numpy().astype(np.float64))
            for t, p, q in self.trajectory
        ]

    def health_check(self) -> dict:
        """On-demand estimator health report (reads the device): NaN state,
        covariance conditioning, map pressure (overflow drops).  With a
        group, the map's size and drops are summed over the ranks (a
        collective)."""
        P = self.P.detach().cpu().numpy()
        nan_state = any(bool(torch.isnan(v).any()) for v in self.x) or bool(
            np.isnan(P).any())
        eig = np.linalg.eigvalsh(0.5 * (P + P.T)) if not nan_state else None
        size_drops = torch.stack([hm.map_size(self.map),
                                  self.map.dropped.sum(dtype=torch.int64)])
        if self.group is not None:
            # an eager collective between two replays of the captured step:
            # NCCL takes captured and eager work on one communicator, in the
            # order the ranks issue it, so every rank calls this here
            size_drops = self.group.all_reduce_sum(size_drops)
        size, dropped = size_drops.tolist()
        return {
            "nan": nan_state,
            "p_min_eig": float(eig.min()) if eig is not None else float("nan"),
            "p_max_eig": float(eig.max()) if eig is not None else float("nan"),
            "map_size": size,
            "map_dropped": dropped,
            "truncated_points": self.truncated_points,
            "scans": len(self.trajectory),
            "imu_initialized": not self.imu_need_init,
            "map_built": self.map_built,
        }

    def measure_stage_times(self) -> dict:
        """Device seconds of the search / incremental / delete stage groups
        at this pipeline's shapes against a copy of its live map — the
        sources of the timing CSV's stage columns (``utils.stage_timing``).
        A sharded pipeline times them against the global map, as the JAX
        package does against its mesh's global array: every rank gathers
        it (``sharding.gather_global_map``, a collective, so every rank
        calls this), and its layout is the single map's."""
        from .utils.stage_timing import measure_stage_times

        m = self.map
        if self.group is not None:
            m = sharding.gather_global_map(m, self.group)
        return measure_stage_times(self, m)

    def pose_covariance(self) -> np.ndarray:
        """6x6 pose covariance, rotation block first (publish_odometry,
        laserMapping.cpp:596-606)."""
        P = self.P.detach().cpu().numpy().astype(np.float64)
        out = np.zeros((6, 6))
        out[:3, :3] = P[3:6, 3:6]  # rot
        out[3:, 3:] = P[0:3, 0:3]  # pos
        out[:3, 3:] = P[3:6, 0:3]
        out[3:, :3] = P[0:3, 3:6]
        return out

    def last_cloud_world_dense(self):
        """Dense world-frame cloud (+intensity) of the last processed scan
        (publish_frame_world dense mode, laserMapping.cpp:504-529): every
        deskewed return transformed by the scan's posterior pose."""
        if self.last_pts_body is None:
            return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32))
        pts = meas.body_to_world(self.x, self.last_pts_body)
        mask = self.last_pts_body_mask.cpu().numpy()
        return (pts.detach().cpu().numpy()[mask],
                self.last_pts_body_intensity.detach().cpu().numpy()[mask])

    def push_lidar(self, stamp, pts, pt_time, intensity=None,
                   preprocess_time=0.0):
        self.sync.push_lidar(float(stamp), pts, pt_time, intensity,
                             preprocess_time)

    def push_imu(self, t, acc, gyr):
        self.sync.push_imu(float(t), acc, gyr)

    def spin_once(self) -> bool:
        """Process at most one synced packet.  Returns True if one was run."""
        pkt = self.sync.pop_packet()
        if pkt is None:
            return False
        self.process_packet(pkt)
        return True

    def _run_step(self, pkt, last_end_rel, pcl_end_rel, ekf_inited,
                  pad) -> dict:
        """Pack the scan, hand it to the device and run the step: a graph
        replay (its first scan in a bucket runs eagerly, then the capture),
        or the eager step.  Returns the step's outputs, copied off the
        graph's tensors where a graph ran."""
        args = (self.cfg, self.acc_scale, pkt, last_end_rel, pcl_end_rel,
                ekf_inited, self.map_built, pad)
        if self.feed is None:  # the CPU: a fresh buffer, no copy
            return self._packed_step(torch.from_numpy(pack_buf(*args)))
        host = self.feed.take(8 + self.cfg.n_imu_max * 7 + pad * 5)
        pack_buf(*args, out=host.numpy())
        if self.graphs is not None:
            # the next replay overwrites the graph's outputs, and the next
            # scan its input buffer (which the intensity cloud views)
            out = {k: v.clone()
                   for k, v in self.graphs.run(host, self._packed_step).items()}
        else:
            buf = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            buf.copy_(host, non_blocking=True)
            out = self._packed_step(buf)
        self.feed.copied()
        return out

    def process_packet(self, pkt: ScanPacket):
        t0 = time.perf_counter()
        cfg = self.cfg
        diag = StepDiag(n_raw=len(pkt.pts), preprocess_time=pkt.preprocess_time)

        if self.first_lidar_time is None:
            self.first_lidar_time = pkt.lidar_beg_time

        # ---- IMU static init phase (IMU_Processing.hpp:356-380) ----
        if self.imu_need_init:
            if len(pkt.imu_t):
                self.imu_stats = imu_mod.update_stats(
                    self.imu_stats, pkt.imu_acc, pkt.imu_gyr)
                if self.imu_stats.n > cfg.max_ini_count:
                    x, P = imu_mod.make_init_state(
                        self.imu_stats, cfg.extrinsic_R_mat,
                        cfg.extrinsic_T_vec, self.dtype, self.device)
                    self.load_state(x=x, P=P)
                    self.acc_scale = float(
                        st.G_M_S2 / np.linalg.norm(self.imu_stats.mean_acc))
                    self.imu_need_init = False
            self.last_lidar_end_time = pkt.lidar_end_time
            return

        last_end_rel = self.last_lidar_end_time - pkt.lidar_beg_time
        pcl_end_rel = pkt.lidar_end_time - pkt.lidar_beg_time
        ekf_inited = (pkt.lidar_beg_time - self.first_lidar_time) >= cfg.init_time
        pad = self._pad_for(len(pkt.pts))
        truncated = max(0, len(pkt.pts) - pad)
        if truncated:
            self.truncated_points += truncated
            if not self._warned_truncation:
                self._warned_truncation = True
                warnings.warn(
                    f"scan of {len(pkt.pts)} points exceeds the largest pad "
                    f"bucket {pad}; {truncated} points dropped (this is "
                    "counted in health_check()['truncated_points'] — raise "
                    "Config.n_points_max or add a pad bucket)")
        diag.n_truncated = truncated

        # no host<->device sync below but the startup read and, with
        # stage_timing, the wait for the outputs
        out = self._run_step(pkt, last_end_rel, pcl_end_rel, ekf_inited, pad)
        n_down, n_eff, iters, map_size = out["diag"]
        if not self.map_built:
            # one-time read during startup: did the first scan seed the map?
            self.map_built = int(n_down) > 5

        self.last_lidar_end_time = pkt.lidar_end_time
        self.last_pts_world = out["world"]
        self.last_pts_world_mask = out["world_mask"]
        self.last_pts_world_intensity = out["world_intensity"]
        self.last_pts_body = out["body"]
        self.last_pts_body_mask = out["body_mask"]
        self.last_pts_body_intensity = out["body_intensity"]

        diag.n_effective = n_eff
        diag.iterations = iters
        diag.n_down = n_down
        diag.map_size = map_size
        if cfg.stage_timing:
            # real per-scan latency: wait for the step's outputs
            float(out["pose"][0])
            int(map_size)
        diag.total_time = time.perf_counter() - t0
        self.diags.append(diag)
        pose = out["pose"]
        self.trajectory.append((pkt.lidar_end_time, pose[:3], pose[3:]))
        if cfg.runtime_pos_log:
            self.state_log.append(
                (pkt.lidar_beg_time, st.State(*(v.clone() for v in self.x))))

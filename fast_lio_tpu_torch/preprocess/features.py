"""LOAM-style feature extraction (optional path, default OFF).

Re-implementation of the reference's per-ring classifier
(FAST_LIO's src/preprocess.cpp:483-957; port of
``fast_lio_tpu/preprocess/features.py``, the same numpy code): ``give_feature`` +
``plane_judge`` + ``edge_jump_judge``.  Every launch file ships with
``feature_extract_enable = false`` and only the surface cloud is consumed
downstream (preprocess.cpp:47,89 — the corner cloud is computed and dropped),
so this path exists for parity and experimentation, not the hot loop; it is
host-side Python like the reference's single-threaded handler.

Constants mirror the Preprocess constructor (preprocess.cpp:6-32).  Note the
reference never initializes ``disB`` (the ``// B?`` comment at :14); on the
zero-initialized allocations it effectively runs with disB = 0, which we
adopt.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from ..config import Config, LidarType

# preprocess.cpp:9-31
INF_BOUND = 10.0
GROUP_SIZE = 8
DIS_A = 0.1
DIS_B = 0.0
P2L_RATIO = 225.0
LIMIT_MAXMID = 6.25
LIMIT_MIDMIN = 6.25
LIMIT_MAXMIN = 3.24
JUMP_UP_LIMIT = math.cos(170.0 / 180.0 * math.pi)
JUMP_DOWN_LIMIT = math.cos(8.0 / 180.0 * math.pi)
COS160 = math.cos(160.0 / 180.0 * math.pi)
EDGE_A = 2.0
EDGE_B = 0.1
SMALLP_INTERSECT = math.cos(172.5 / 180.0 * math.pi)
SMALLP_RATIO = 1.2

# feature types (preprocess.h:19)
NOR, POSS_PLANE, REAL_PLANE, EDGE_JUMP, EDGE_PLANE, WIRE, ZERO_POINT = range(7)
# edge-jump classes (preprocess.h:21)
NR_NOR, NR_ZERO, NR_180, NR_INF, NR_BLIND = range(5)
PREV, NEXT = 0, 1


def _plane_judge(pts, rng2d, dista, i_cur, blind, is_avia):
    """preprocess.cpp:806-918.  Returns (plane_type, i_nex, direct)."""
    n = len(pts)
    group_dis = (DIS_A * rng2d[i_cur] + DIS_B) ** 2
    disarr = []
    i_nex = i_cur
    for i_nex in range(i_cur, i_cur + GROUP_SIZE):
        if i_nex >= n:
            return 2, min(i_nex, n - 1), np.zeros(3)
        if rng2d[i_nex] < blind:
            return 2, i_nex, np.zeros(3)
        disarr.append(dista[i_nex])
    i_nex = i_cur + GROUP_SIZE
    vx = vy = vz = 0.0
    while i_cur < n and i_nex < n:
        if rng2d[i_nex] < blind:
            return 2, i_nex, np.zeros(3)
        d = pts[i_nex] - pts[i_cur]
        vx, vy, vz = d
        two_dis = float(d @ d)
        if two_dis >= group_dis:
            break
        disarr.append(dista[i_nex])
        i_nex += 1
    else:
        d = pts[min(i_nex, n - 1)] - pts[i_cur]
        vx, vy, vz = d
        two_dis = float(d @ d)

    # max squared point-to-line lever arm within the group
    seg = pts[i_cur + 1 : i_nex] - pts[i_cur]
    if len(seg):
        cr = np.cross(seg, np.array([vx, vy, vz]))
        leng_wid = float(np.max(np.einsum("ij,ij->i", cr, cr)))
    else:
        leng_wid = 0.0
    if leng_wid <= 0 or (two_dis * two_dis / leng_wid) < P2L_RATIO:
        return 0, i_nex, np.zeros(3)

    disarr = np.sort(np.asarray(disarr))[::-1]
    if disarr[-2] < 1e-16:
        return 0, i_nex, np.zeros(3)

    if is_avia:
        dismax_mid = disarr[0] / max(disarr[len(disarr) // 2], 1e-300)
        dismid_min = disarr[len(disarr) // 2] / max(disarr[-2], 1e-300)
        if dismax_mid >= LIMIT_MAXMID or dismid_min >= LIMIT_MIDMIN:
            return 0, i_nex, np.zeros(3)
    else:
        if disarr[0] / max(disarr[-2], 1e-300) >= LIMIT_MAXMIN:
            return 0, i_nex, np.zeros(3)

    direct = np.array([vx, vy, vz])
    nrm = np.linalg.norm(direct)
    return 1, i_nex, direct / nrm if nrm > 0 else direct


def _edge_jump_judge(rng2d, dista, i, nor_dir, blind):
    """preprocess.cpp:920-957."""
    if nor_dir == PREV:
        if i < 2 or rng2d[i - 1] < blind or rng2d[i - 2] < blind:
            return False
    else:
        if i + 2 >= len(rng2d) or rng2d[i + 1] < blind or rng2d[i + 2] < blind:
            return False
    d1 = dista[i + nor_dir - 1]
    d2 = dista[i + 3 * nor_dir - 2]
    if d1 < d2:
        d1, d2 = d2, d1
    d1, d2 = math.sqrt(d1), math.sqrt(d2)
    return not (d1 > EDGE_A * d2 or (d1 - d2) > EDGE_B)


def give_feature(
    pts: np.ndarray,  # (n, 3) one ring, scan order
    intens: np.ndarray,
    times: np.ndarray,
    cfg: Config,
) -> Tuple[List[int], List[Tuple], List[int]]:
    """Classify one ring.  Returns (surf emissions, corner indices) where a
    surf emission is either an index or an averaged group (preprocess.cpp:
    745-794 emits averaged surf points every point_filter_num)."""
    n = len(pts)
    if n == 0:
        return [], [], []
    is_avia = cfg.lidar_type == LidarType.AVIA
    blind = cfg.blind
    rng2d = np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
    diffs = np.diff(pts, axis=0)
    dista = np.concatenate([np.einsum("ij,ij->i", diffs, diffs), [0.0]])
    ftype = np.full(n, NOR, np.int8)
    edj = np.full((n, 2), NR_NOR, np.int8)
    intersect = np.full(n, 2.0)

    head = 0
    while head < n and rng2d[head] < blind:
        head += 1

    # --- surf group pass (preprocess.cpp:499-607) ---
    plsize2 = n - GROUP_SIZE if n > GROUP_SIZE else 0
    last_state = 0
    last_direct = np.zeros(3)
    i = head
    while i < plsize2:
        if rng2d[i] < blind:
            i += 1
            continue
        plane_type, i_nex, curr_direct = _plane_judge(
            pts, rng2d, dista, i, blind, is_avia
        )
        if plane_type == 1:
            for j in range(i, min(i_nex, n - 1) + 1):
                ftype[j] = REAL_PLANE if (j != i and j != i_nex) else POSS_PLANE
            if last_state == 1 and np.linalg.norm(last_direct) > 0.1:
                mod = float(last_direct @ curr_direct)
                ftype[i] = EDGE_PLANE if -0.707 < mod < 0.707 else REAL_PLANE
            i = i_nex - 1
            last_state = 1
        else:
            i = i_nex
            last_state = 0
        last_direct = curr_direct
        i += 1

    # --- edge-jump pass (preprocess.cpp:609-703) ---
    for i in range(head + 3, n - 3):
        if rng2d[i] < blind or ftype[i] >= REAL_PLANE:
            continue
        if dista[i - 1] < 1e-16 or dista[i] < 1e-16:
            continue
        vec_a = pts[i]
        vecs = [None, None]
        ok = [True, True]
        for j, m in ((PREV, -1), (NEXT, 1)):
            if rng2d[i + m] < blind:
                edj[i, j] = NR_INF if rng2d[i] > INF_BOUND else NR_BLIND
                ok[j] = False
                continue
            v = pts[i + m] - vec_a
            vecs[j] = v
            ang = float(vec_a @ v) / (np.linalg.norm(vec_a) * np.linalg.norm(v))
            if ang < JUMP_UP_LIMIT:
                edj[i, j] = NR_180
            elif ang > JUMP_DOWN_LIMIT:
                edj[i, j] = NR_ZERO
        if ok[PREV] and ok[NEXT]:
            intersect[i] = float(vecs[PREV] @ vecs[NEXT]) / (
                np.linalg.norm(vecs[PREV]) * np.linalg.norm(vecs[NEXT])
            )
        e0, e1 = edj[i, PREV], edj[i, NEXT]
        if e0 == NR_NOR and e1 == NR_ZERO and dista[i] > 0.0225 and \
                dista[i] > 4 * dista[i - 1]:
            if intersect[i] > COS160 and _edge_jump_judge(rng2d, dista, i, PREV, blind):
                ftype[i] = EDGE_JUMP
        elif e0 == NR_ZERO and e1 == NR_NOR and dista[i - 1] > 0.0225 and \
                dista[i - 1] > 4 * dista[i]:
            if intersect[i] > COS160 and _edge_jump_judge(rng2d, dista, i, NEXT, blind):
                ftype[i] = EDGE_JUMP
        elif e0 == NR_NOR and e1 == NR_INF:
            if _edge_jump_judge(rng2d, dista, i, PREV, blind):
                ftype[i] = EDGE_JUMP
        elif e0 == NR_INF and e1 == NR_NOR:
            if _edge_jump_judge(rng2d, dista, i, NEXT, blind):
                ftype[i] = EDGE_JUMP
        elif e0 > NR_NOR and e1 > NR_NOR:
            if ftype[i] == NOR:
                ftype[i] = WIRE

    # --- small-plane smoothing (preprocess.cpp:705-743) ---
    for i in range(head + 1, n - 1):
        if rng2d[i] < blind or rng2d[i - 1] < blind or rng2d[i + 1] < blind:
            continue
        if dista[i - 1] < 1e-8 or dista[i] < 1e-8:
            continue
        if ftype[i] == NOR:
            ratio = (dista[i - 1] / dista[i]) if dista[i - 1] > dista[i] \
                else (dista[i] / dista[i - 1])
            if intersect[i] < SMALLP_INTERSECT and ratio < SMALLP_RATIO:
                if ftype[i - 1] == NOR:
                    ftype[i - 1] = REAL_PLANE
                if ftype[i + 1] == NOR:
                    ftype[i + 1] = REAL_PLANE
                ftype[i] = REAL_PLANE

    # --- emission (preprocess.cpp:745-794) ---
    surf_pts, surf_int, surf_t = [], [], []
    corn_idx = []
    last_surface = -1
    for j in range(head, n):
        if ftype[j] in (POSS_PLANE, REAL_PLANE):
            if last_surface == -1:
                last_surface = j
            if j == last_surface + cfg.point_filter_num - 1:
                surf_pts.append(pts[j])
                surf_int.append(intens[j])
                surf_t.append(times[j])
                last_surface = -1
        else:
            if ftype[j] in (EDGE_JUMP, EDGE_PLANE):
                corn_idx.append(j)
            if last_surface != -1:
                sl = slice(last_surface, j)
                surf_pts.append(pts[sl].mean(axis=0))
                surf_int.append(intens[sl].mean())
                surf_t.append(times[sl].mean())
            last_surface = -1
    return (surf_pts, surf_int, surf_t), corn_idx, ftype


def extract_surfaces(msg: dict, scan, cfg: Config):
    """Feature-mode driver: group raw returns by ring, run give_feature,
    emit the surf cloud (corners are computed and dropped downstream, like
    the reference)."""
    from .drivers import RawScan

    if cfg.lidar_type == LidarType.AVIA:
        xyz = msg["xyz"]
        keep = (msg["line"] < cfg.n_scans) & (
            ((msg["tag"] & 0x30) == 0x10) | ((msg["tag"] & 0x30) == 0x00)
        )
        # duplicate suppression (preprocess.cpp:124-130)
        prev = np.roll(xyz, 1, axis=0)
        keep &= np.abs(xyz - prev).max(axis=1) > 1e-7
        keep[0] = False
        rings = msg["line"]
        t_s = msg["offset_time_ns"] * 1e-9
        inten = msg["reflectivity"]
    else:
        xyz = msg["xyz"]
        rings = msg.get("ring", np.zeros(len(xyz), np.int32))
        keep = rings < cfg.n_scans
        tfield = msg.get("time", msg.get("t", np.zeros(len(xyz))))
        t_s = np.asarray(tfield, np.float64) * cfg.time_unit.to_ms * 1e-3
        inten = msg.get("intensity", np.zeros(len(xyz), np.float32))

    all_pts, all_int, all_t = [], [], []
    for ring in range(cfg.n_scans):
        sel = keep & (rings == ring)
        if sel.sum() <= 5:
            continue
        (sp, si, stt), _corners, _ft = give_feature(
            xyz[sel].astype(np.float64), np.asarray(inten)[sel],
            np.asarray(t_s)[sel], cfg,
        )
        all_pts.extend(sp)
        all_int.extend(si)
        all_t.extend(stt)
    if not all_pts:
        return RawScan(np.zeros((0, 3), np.float32), np.zeros(0),
                       np.zeros(0, np.float32))
    order = np.argsort(np.asarray(all_t))
    return RawScan(
        pts=np.asarray(all_pts, np.float32)[order],
        time_offset_s=np.asarray(all_t, np.float64)[order],
        intensity=np.asarray(all_int, np.float32)[order],
    )

"""A plain PyTorch reference of one FAST-LIO2 scan: the yardstick that the
benchmark holds the port's outputs to.

Written from FAST-LIO2's equations (laserMapping.cpp, IMU_Processing.hpp,
esekfom.hpp, use-ikfom.hpp, IKFoM's SOn.hpp and S2.hpp) in straightforward
tensor code: one state, a loop over the IMU samples, a point set for the map.
It imports nothing of the port and takes nothing the port made: its map is a
list of points, its kNN a search of those points by their storage cells.
What it shares with the port is the semantics the port documents as its
own:

* the intended math of the IKFoM manifold (exp factors included where the
  C++ integer division ``scalar(1/2)`` drops them);
* the iterated update in the information form, ``max_iteration + 1`` passes
  at most, the re-search forced before the last pass, the exit after two
  converged passes;
* a point's plane: the orthogonal regression of its five neighbours,
  rejected when a neighbour lies more than 0.1 m off it;
* the kNN over the map's storage cells (side ``map_cell_multiplier`` map
  voxels): the 2x2x2 cells nearest the query, and with the wide fallback the
  3x3x3 cells around it for the queries the narrow search leaves short;
* the input downsample: the centroid of each occupied voxel, the voxels in
  ascending (x, y, z) order, the first ``n_ds_max`` kept;
* the map insert's hysteresis (laserMapping.cpp:427-474) and one point per
  map voxel for the downsampled inserts, nearest the voxel centre; the
  map's fixed capacity: a storage cell's points share one of 2^map_h_log2
  buckets of a fixed number of slots, found by a spatial hash, and a point
  that finds its bucket full is dropped;
* the local-map cube (laserMapping.cpp:231-277), which prunes the map
  whenever it moves.

``RefLIO(cfg, dtype, device)`` takes packets as the port's ``Pipeline`` does
(fields ``lidar_beg_time``, ``lidar_end_time``, ``pts``, ``pt_time``,
``imu_t``, ``imu_acc``, ``imu_gyr``); ``load`` starts it from a given state
instead.  Matrix products go through ``torch.matmul``, so with TF32 allowed
on a CUDA device (``torch.backends.cuda.matmul.allow_tf32``) the same code in
float32 is the lower-precision control.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

G_M_S2 = 9.81
S2_LEN = 9.809
TOL = 1e-11
NUM_MATCH = 5
MAX_NN_SQ = 5.0
PLANE_THR = 0.1
S_GATE = 0.9
MOV_THRESHOLD = 1.5
DOF = 23
POS, ROT, OFR, OFT, VEL, BG, BA, GRV = 0, 3, 6, 9, 12, 15, 18, 21
STATE_KEYS = ("pos", "rot", "offR", "offT", "vel", "bg", "ba", "grav")
MARSIM = 4  # the lidar type whose scans are not deskewed


# --------------------------------------------------------------------------
# rotations (quaternions w, x, y, z)
# --------------------------------------------------------------------------

def hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def qmul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def qmat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def qexp(v):
    """Rotation vector -> quaternion of the rotation by |v| about v."""
    t2 = (v * v).sum(-1)
    t = torch.sqrt(t2)
    small = t2 < 1e-12
    ts = torch.where(small, torch.ones_like(t), t)
    c = torch.where(small, 1 - t2 / 8, torch.cos(0.5 * ts))
    s = torch.where(small, 0.5 - t2 / 48, torch.sin(0.5 * ts) / ts)
    return torch.cat([c[..., None], s[..., None] * v], -1)


def qlog(q):
    """Quaternion -> rotation vector; q and -q give the same (atan, not
    atan2: SO3::log's periodicity)."""
    w, v = q[..., 0], q[..., 1:]
    nv = torch.sqrt((v * v).sum(-1))
    small = nv < TOL
    nvs = torch.where(small, torch.ones_like(nv), nv)
    k = torch.where(small, 2.0 / w, 2.0 * torch.atan(nvs / w) / nvs)
    return k[..., None] * v


def rot_exp_matrix(v):
    return qmat(qexp(v))


def a_matrix(v):
    """IKFoM's A(v) (mtkmath.hpp:236-247)."""
    sq = (v * v).sum(-1)
    n = torch.sqrt(sq)
    small = n < TOL
    sqs = torch.where(small, torch.ones_like(sq), sq)
    ns = torch.where(small, torch.ones_like(n), n)
    H = hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    A = (eye + ((1 - torch.cos(ns)) / sqs)[..., None, None] * H
         + ((1 - torch.sin(ns) / ns) / sqs)[..., None, None] * (H @ H))
    return torch.where(small[..., None, None], eye.expand_as(A), A)


# --------------------------------------------------------------------------
# the gravity sphere S2 (S2_typ = 1, radius 9.809)
# --------------------------------------------------------------------------

def s2_bx(vec):
    v0, v1, v2 = vec.unbind(-1)
    ok = v0 + S2_LEN > TOL
    d = torch.where(ok, S2_LEN + v0, torch.ones_like(v0))
    res = torch.stack([torch.stack([-v1, -v2]),
                       torch.stack([S2_LEN - v1 * v1 / d, -v2 * v1 / d]),
                       torch.stack([-v2 * v1 / d, S2_LEN - v2 * v2 / d])]
                      ) / S2_LEN
    degen = torch.zeros_like(res)
    degen[1, 1] = -1.0
    degen[2, 0] = 1.0
    return torch.where(ok, res, degen)


def s2_boxplus(vec, d2):
    return rot_exp_matrix(s2_bx(vec) @ d2) @ vec


def s2_boxminus(vec, other):
    v_sin = torch.linalg.norm(hat(vec) @ other)
    v_cos = vec @ other
    theta = torch.atan2(v_sin, v_cos)
    gen = (theta / torch.clamp_min(v_sin, TOL)) * (
        s2_bx(other).T @ (hat(other) @ vec))
    pi = torch.stack([torch.full_like(theta, 3.1415926),
                      torch.zeros_like(theta)])
    special = torch.where(theta.abs() > TOL, pi, torch.zeros_like(pi))
    return torch.where(v_sin < TOL, special, gen)


def s2_nx(vec):
    return s2_bx(vec).T @ hat(vec) / (S2_LEN * S2_LEN)


def s2_mx(vec, d2):
    Bx = s2_bx(vec)
    Bu = Bx @ d2
    gen = -(rot_exp_matrix(Bu) @ hat(vec) @ a_matrix(Bu).T @ Bx)
    return torch.where(torch.linalg.norm(d2) < TOL, -(hat(vec) @ Bx), gen)


# --------------------------------------------------------------------------
# the state (use-ikfom.hpp:12-21) and its manifold operations
# --------------------------------------------------------------------------

def boxplus(x, dx):
    return dict(pos=x["pos"] + dx[POS:POS + 3],
                rot=qmul(x["rot"], qexp(dx[ROT:ROT + 3])),
                offR=qmul(x["offR"], qexp(dx[OFR:OFR + 3])),
                offT=x["offT"] + dx[OFT:OFT + 3],
                vel=x["vel"] + dx[VEL:VEL + 3],
                bg=x["bg"] + dx[BG:BG + 3],
                ba=x["ba"] + dx[BA:BA + 3],
                grav=s2_boxplus(x["grav"], dx[GRV:GRV + 2]))


def boxminus(x, y):
    return torch.cat([x["pos"] - y["pos"],
                      qlog(qmul(qconj(y["rot"]), x["rot"])),
                      qlog(qmul(qconj(y["offR"]), x["offR"])),
                      x["offT"] - y["offT"], x["vel"] - y["vel"],
                      x["bg"] - y["bg"], x["ba"] - y["ba"],
                      s2_boxminus(x["grav"], y["grav"])])


def transport(dx, x, x_prop):
    """The 23x23 tangent transport of the update (esekfom.hpp:1668-1691):
    A(dx)^T on the two SO3 blocks, Nx(x) Mx(x_prop, dx) on the S2 block."""
    T = torch.eye(DOF, dtype=dx.dtype, device=dx.device)
    T[ROT:ROT + 3, ROT:ROT + 3] = a_matrix(dx[ROT:ROT + 3]).T
    T[OFR:OFR + 3, OFR:OFR + 3] = a_matrix(dx[OFR:OFR + 3]).T
    T[GRV:GRV + 2, GRV:GRV + 2] = s2_nx(x["grav"]) @ s2_mx(
        x_prop["grav"], dx[GRV:GRV + 2])
    return T


def predict(x, P, dt, Q, acc, gyr):
    """One IMU propagation (esekfom.hpp:279-383, use-ikfom.hpp:47-88)."""
    R = qmat(x["rot"])
    omega = gyr - x["bg"]
    f_vel = R @ (acc - x["ba"]) + x["grav"]
    eye3 = torch.eye(3, dtype=P.dtype, device=P.device)
    fx = torch.zeros((DOF, DOF), dtype=P.dtype, device=P.device)
    fw = torch.zeros((DOF, 12), dtype=P.dtype, device=P.device)
    fx[POS:POS + 3, VEL:VEL + 3] = eye3
    fx[VEL:VEL + 3, ROT:ROT + 3] = -R @ hat(acc - x["ba"])
    fx[VEL:VEL + 3, BA:BA + 3] = -R
    fx[VEL:VEL + 3, GRV:GRV + 2] = s2_mx(x["grav"], P.new_zeros(2))
    fx[ROT:ROT + 3, BG:BG + 3] = -eye3
    fw[VEL:VEL + 3, 3:6] = -R
    fw[ROT:ROT + 3, 0:3] = -eye3
    fw[BG:BG + 3, 6:9] = eye3
    fw[BA:BA + 3, 9:12] = eye3
    # the SO3 rows transported by A(-f dt), their diagonal block exp(-f dt)
    seg = -omega * dt
    A = a_matrix(seg)
    fx[ROT:ROT + 3] = A @ fx[ROT:ROT + 3]
    fw[ROT:ROT + 3] = A @ fw[ROT:ROT + 3]
    F = torch.eye(DOF, dtype=P.dtype, device=P.device)
    F[ROT:ROT + 3, ROT:ROT + 3] = rot_exp_matrix(seg)
    # gravity: f's rows are zero, the diagonal block Nx Mx at the same point
    F[GRV:GRV + 2, GRV:GRV + 2] = s2_nx(x["grav"]) @ s2_mx(
        x["grav"], P.new_zeros(2))
    F = F + fx * dt
    Fw = fw * dt
    x_new = dict(x, pos=x["pos"] + x["vel"] * dt,
                 rot=qmul(x["rot"], qexp(omega * dt)),
                 vel=x["vel"] + f_vel * dt)
    P_new = F @ P @ F.T + Fw @ Q @ Fw.T
    return x_new, 0.5 * (P_new + P_new.T)


# --------------------------------------------------------------------------
# the map: a point set searched by storage cell
# --------------------------------------------------------------------------

_KEY_OFF = 1 << 20


def cell_keys(cells):
    """(..., 3) integer cells -> one int64 key each (|cell| < 2^20)."""
    c = cells.to(torch.int64) + _KEY_OFF
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


_P1, _P2, _P3 = 73856093, 19349663, 83492791
_M32 = 0xFFFFFFFF


def _mul32(h, c: int):
    return (((h * (c & 0xFFFF)) & _M32) + (((h * (c >> 16)) & 0xFFFF) << 16)
            ) & _M32


def bucket_of(cells, h_log2: int):
    """The map's bucket of integer cells (..., 3): the spatial hash of the
    cell (its coordinates times three primes, xor'd, then murmur3's 32-bit
    finaliser), its low ``h_log2`` bits."""
    c = cells.to(torch.int64)
    h = ((c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h & ((1 << h_log2) - 1)


class PointMap:
    """The map as points (M, 3) in storage order, with an index of its
    storage cells for the search.  A storage cell's points live in one of
    2^h_log2 buckets of ``slots`` points (its hash's), and a point that
    finds its bucket full is dropped."""

    def __init__(self, pts, voxel: float, cell: float, h_log2: int,
                 slots: int):
        self.pts = pts
        self.voxel = voxel
        self.cell = cell
        self.h_log2 = h_log2
        self.slots = slots
        self.dropped = 0
        self._index = None

    def changed(self):
        self._index = None

    def index(self):
        if self._index is None:
            keys = cell_keys(torch.floor(self.pts / self.cell))
            keys_s, order = torch.sort(keys, stable=True)
            uniq, counts = torch.unique_consecutive(keys_s,
                                                    return_counts=True)
            starts = torch.cumsum(counts, 0) - counts
            self._index = (order, uniq, starts, counts)
        return self._index

    def knn(self, q, wide: bool, k: int = NUM_MATCH):
        """The k nearest map points of each query (N, 3) among the points
        of its region's cells: (nbrs (N, k, 3), sq (N, k) +inf where none,
        found (N, k))."""
        N = q.shape[0]
        dt, dev = q.dtype, q.device
        span = 3 if wide else 2
        base = torch.floor(q / self.cell - (1.0 if wide else 0.5)).long()
        r = torch.arange(span, device=dev)
        off = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                          -1).reshape(-1, 3)
        cells = base[:, None, :] + off[None]  # (N, R, 3)
        if self.pts.shape[0] == 0:
            return (q.new_zeros((N, k, 3)),
                    torch.full((N, k), math.inf, dtype=dt, device=dev),
                    torch.zeros((N, k), dtype=torch.bool, device=dev))
        order, uniq, starts, counts = self.index()
        keys = cell_keys(cells)
        pos = torch.searchsorted(uniq, keys).clamp_max(uniq.numel() - 1)
        hit = uniq[pos] == keys
        cnt = torch.where(hit, counts[pos], torch.zeros_like(pos))
        st = torch.where(hit, starts[pos], torch.zeros_like(pos))
        cmax = max(int(cnt.max()), 1)
        j = torch.arange(cmax, device=dev)
        ok = j[None, None, :] < cnt[..., None]  # (N, R, C)
        idx = order[(st[..., None] + j).clamp_max(order.numel() - 1)]
        cand = self.pts.to(dt)[idx].reshape(N, -1, 3)
        d2 = ((cand - q[:, None, :]) ** 2).sum(-1)
        d2 = torch.where(ok.reshape(N, -1), d2, torch.full_like(d2, math.inf))
        if d2.shape[1] < k:
            d2 = torch.cat([d2, d2.new_full((N, k - d2.shape[1]), math.inf)],
                           1)
            cand = torch.cat([cand, cand.new_zeros(
                (N, k - cand.shape[1], 3))], 1)
        sq, pick = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        nbrs = torch.take_along_dim(cand, pick[..., None], dim=1)
        return nbrs, sq, torch.isfinite(sq)

    def prune(self, lo, hi):
        keep = ((self.pts >= lo) & (self.pts <= hi)).all(-1)
        if not bool(keep.all()):
            self.pts = self.pts[keep]
            self.changed()

    def _buckets(self, pts):
        return bucket_of(torch.floor(pts / self.cell), self.h_log2)

    def insert(self, pts, add, ds):
        """Add the scan's points: those flagged ``ds`` keep one point per
        map voxel, the one nearest the voxel centre (a new winner replaces
        the first point already in its voxel only if nearer, and is dropped
        otherwise); the others are appended.  The appended points of a
        bucket take its free slots in the order of their voxels (x, y, z),
        the ``ds`` ones first, then the others in the scan's order; those
        past its free slots are dropped."""
        v = self.voxel
        mid = torch.floor(pts / v) * v + 0.5 * v
        d_mid = ((pts - mid) ** 2).sum(-1)
        vox_key = cell_keys(torch.floor(pts / v))
        cand = torch.nonzero(add & ds).flatten()
        append = [torch.nonzero(add & ~ds).flatten()]  # scan order
        if cand.numel():
            keys = vox_key[cand]
            o1 = torch.sort(d_mid[cand], stable=True).indices
            o2 = o1[torch.sort(keys[o1], stable=True).indices]
            ks = keys[o2]
            first = torch.ones_like(ks, dtype=torch.bool)
            first[1:] = ks[1:] != ks[:-1]
            win = cand[o2[first]]  # in voxel order
            wkeys = ks[first]
            has = torch.zeros_like(win, dtype=torch.bool)
            mine = self.pts.to(pts.dtype)
            if mine.shape[0]:
                ms, mo = torch.sort(cell_keys(torch.floor(mine / v)),
                                    stable=True)
                at = torch.searchsorted(ms, wkeys).clamp_max(ms.numel() - 1)
                has = ms[at] == wkeys
                slot = mo[at]
                replace = has & (d_mid[win] < (
                    (mine[slot] - mid[win]) ** 2).sum(-1))
                if bool(replace.any()):
                    self.pts = self.pts.clone()
                    self.pts[slot[replace]] = pts[win[replace]].to(
                        self.pts.dtype)
            append.insert(0, win[~has])
        order = torch.cat(append)
        if order.numel() == 0:
            return
        new = pts[order]
        # the bucket's free slots, taken in this order
        bucket = self._buckets(new)
        H = 1 << self.h_log2
        used = torch.bincount(self._buckets(self.pts.to(pts.dtype)),
                              minlength=H) if self.pts.shape[0] else \
            torch.zeros(H, dtype=torch.int64, device=pts.device)
        rank_order = torch.sort(bucket, stable=True)
        b_s = rank_order.values
        first = torch.ones_like(b_s, dtype=torch.bool)
        first[1:] = b_s[1:] != b_s[:-1]
        pos = torch.arange(b_s.numel(), device=pts.device)
        seg = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                           0).values
        rank = torch.empty_like(pos)
        rank[rank_order.indices] = pos - seg
        fits = rank < (self.slots - used[bucket])
        self.dropped += int((~fits).sum())
        self.pts = torch.cat([self.pts, new[fits].to(self.pts.dtype)])
        self.changed()


# --------------------------------------------------------------------------
# the scan step
# --------------------------------------------------------------------------

def fit_planes(nbrs, found):
    """Orthogonal-regression planes of the (N, 5, 3) neighbourhoods:
    (pabcd (N, 4), ok (N,)).  The normal is the port's documented one: two
    steps of inverse iteration on the centred scatter matrix, shifted by
    1e-6 of its trace, from the cross product of two neighbour edges (the
    exact smallest eigenvector moves a scan's pose by up to about 0.1 mm on
    ill-conditioned neighbourhoods, where two steps have not converged)."""
    c = nbrs.mean(1)
    A = nbrs - c[:, None]
    cov = A.transpose(1, 2) @ A
    tr = cov.diagonal(dim1=1, dim2=2).sum(-1)
    seed = torch.linalg.cross(nbrs[:, 1] - nbrs[:, 0], nbrs[:, 2] - nbrs[:, 0])
    sn = torch.linalg.norm(seed, dim=-1)
    n = seed / torch.where(sn > 1e-20, sn, torch.ones_like(sn))[:, None]
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    M = cov + (1e-6 * tr + 1e-12)[:, None, None] * eye
    det = torch.linalg.det(M)
    M = torch.where((det.abs() > 0)[:, None, None], M, eye.expand_as(M))
    for _ in range(2):
        n = torch.linalg.solve(M, n[..., None])[..., 0]
        nn = torch.linalg.norm(n, dim=-1, keepdim=True)
        n = n / torch.where(nn > 1e-20, nn, torch.ones_like(nn))
    d = -(n * c).sum(-1)
    res = ((nbrs * n[:, None]).sum(-1) + d[:, None]).abs()
    ok = (found.all(-1) & (res <= PLANE_THR).all(-1) & (sn > 1e-12)
          & (tr > 1e-12))
    return torch.cat([n, d[:, None]], -1), ok


class RefLIO:
    """The reference pipeline: one stream, packet by packet."""

    def __init__(self, cfg: Dict, dtype=torch.float64, device="cpu"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        dt, dev = dtype, self.device
        Q = torch.zeros((12, 12), dtype=dt, device=dev)
        for i, key in enumerate(("gyr_cov", "acc_cov", "b_gyr_cov",
                                 "b_acc_cov")):
            Q[3 * i:3 * i + 3, 3 * i:3 * i + 3] = torch.eye(3) * cfg[key]
        self.Q = Q
        self.voxel = float(cfg["filter_size_map"])
        mult = int(cfg["map_cell_multiplier"])
        self.cell = float(mult) * self.voxel
        self.h_log2 = int(cfg["map_h_log2"])
        # the map's slots a bucket: as configured, else one storage cell's
        # voxels rounded up to a multiple of 64
        self.slots = int(cfg.get("map_bucket_slots") or
                         max(64, -(-mult ** 3 // 64) * 64))
        self.x = self._tensor_state(dict(
            pos=[0, 0, 0], rot=[1, 0, 0, 0], offR=[1, 0, 0, 0],
            offT=[0, 0, 0], vel=[0, 0, 0], bg=[0, 0, 0], ba=[0, 0, 0],
            grav=[S2_LEN, 0, 0]))
        self.P = torch.eye(DOF, dtype=dt, device=dev)
        self.map = self._map(torch.zeros((0, 3), dtype=dt, device=dev))
        self.angvel_last = torch.zeros(3, dtype=dt, device=dev)
        self.acc_s_last = torch.zeros(3, dtype=dt, device=dev)
        self.lm_lo = torch.zeros(3, dtype=dt, device=dev)
        self.lm_hi = torch.zeros(3, dtype=dt, device=dev)
        self.lm_init = False
        # host state
        self.need_init = True
        self.init_n = 0
        self.mean_acc = np.array([0.0, 0.0, -1.0])
        self.mean_gyr = np.zeros(3)
        self.acc_scale = 1.0
        self.first_lidar_time: Optional[float] = None
        self.last_end = 0.0
        self.map_built = False
        self.passes = 0  # the filter's passes in the last scan

    def _map(self, pts) -> PointMap:
        return PointMap(pts, self.voxel, self.cell, self.h_log2, self.slots)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype,
                               device=self.device)

    def _tensor_state(self, d):
        return {k: self._t(d[k]) for k in STATE_KEYS}

    def load(self, x, P, map_pts, angvel_last, acc_s_last, lm_lo, lm_hi,
             lm_init, acc_scale, first_lidar_time, last_end, map_built):
        """Start from a given state: the filter's (``x`` a dict of
        ``STATE_KEYS``), the map's points in storage order, the IMU carry,
        the local-map cube and the host's scalars."""
        self.x = {k: torch.as_tensor(x[k], device=self.device).to(self.dtype)
                  for k in STATE_KEYS}
        self.P = torch.as_tensor(P, device=self.device).to(self.dtype)
        self.map = self._map(torch.as_tensor(map_pts, device=self.device).to(
            self.dtype))
        self.angvel_last = self._t(angvel_last)
        self.acc_s_last = self._t(acc_s_last)
        self.lm_lo, self.lm_hi = self._t(lm_lo), self._t(lm_hi)
        self.lm_init = bool(lm_init)
        self.need_init = False
        self.acc_scale = float(acc_scale)
        self.first_lidar_time = first_lidar_time
        self.last_end = float(last_end)
        self.map_built = bool(map_built)

    # ---- the host's part (IMU_Processing.hpp:159-214, 356-380) ----

    def process_packet(self, pkt):
        """One synced packet.  Returns the scan's pose (pos (3,), quat (4,))
        or None for a packet the IMU's static init takes."""
        cfg = self.cfg
        if self.first_lidar_time is None:
            self.first_lidar_time = pkt.lidar_beg_time
        if self.need_init:
            self._imu_init(pkt)
            self.last_end = pkt.lidar_end_time
            return None
        n = min(len(pkt.pts), int(cfg["n_points_max"]))
        m = min(len(pkt.imu_t), int(cfg["n_imu_max"]))
        beg = pkt.lidar_beg_time
        ekf_inited = (beg - self.first_lidar_time) >= cfg["init_time"]
        pts = self._t(np.asarray(pkt.pts[:n], np.float64))
        pt_time = self._t(np.asarray(pkt.pt_time[:n], np.float64))
        imu_t = self._t(np.asarray(pkt.imu_t[:m], np.float64) - beg)
        acc = self._t(pkt.imu_acc[:m])
        gyr = self._t(pkt.imu_gyr[:m])
        n_down = self._step(pts, pt_time, imu_t, acc, gyr,
                            self.last_end - beg, pkt.lidar_end_time - beg,
                            ekf_inited)
        if not self.map_built:
            self.map_built = n_down > 5
        self.last_end = pkt.lidar_end_time
        return self.x["pos"], self.x["rot"]

    def _imu_init(self, pkt):
        acc = np.asarray(pkt.imu_acc, np.float64)
        gyr = np.asarray(pkt.imu_gyr, np.float64)
        if not len(acc):
            return
        n = self.init_n
        if n == 0:
            self.mean_acc, self.mean_gyr, n = acc[0].copy(), gyr[0].copy(), 1
        for a, g in zip(acc, gyr):
            self.mean_acc = self.mean_acc + (a - self.mean_acc) / n
            self.mean_gyr = self.mean_gyr + (g - self.mean_gyr) / n
            n += 1
        self.init_n = n
        if n <= self.cfg["max_ini_count"]:
            return
        g = -self.mean_acc / np.linalg.norm(self.mean_acc) * G_M_S2
        R_ext = np.asarray(self.cfg["extrinsic_R"], np.float64).reshape(3, 3)
        self.x["grav"] = self._t(g / np.linalg.norm(g) * S2_LEN)
        self.x["bg"] = self._t(self.mean_gyr)
        self.x["offR"] = self._t(_mat_to_quat(R_ext))
        self.x["offT"] = self._t(self.cfg["extrinsic_T"])
        diag = np.ones(DOF)
        diag[OFR:OFR + 3] = 1e-5
        diag[OFT:OFT + 3] = 1e-5
        diag[BG:BG + 3] = 1e-4
        diag[BA:BA + 3] = 1e-3
        diag[GRV:GRV + 2] = 1e-5
        self.P = torch.diag(self._t(diag))
        self.acc_scale = G_M_S2 / float(np.linalg.norm(self.mean_acc))
        self.need_init = False

    # ---- the device's part ----

    def _step(self, pts, pt_time, imu_t, acc, gyr, last_end_rel, pcl_end_rel,
              ekf_inited) -> int:
        cfg = self.cfg
        pts_d = self._propagate_and_deskew(pts, pt_time, imu_t, acc, gyr,
                                           last_end_rel, pcl_end_rel)
        self._fov_segment()
        down = self._downsample(pts_d)
        found = torch.zeros((down.shape[0], NUM_MATCH), dtype=torch.bool,
                            device=self.device)
        nbrs = down.new_zeros((down.shape[0], NUM_MATCH, 3))
        if self.map_built and down.shape[0]:
            nbrs, found = self._update(down)
        world = self._to_world(self.x, down)
        add, ds = self._insert_decisions(world, nbrs, found, ekf_inited)
        self.map.insert(world, add, ds)
        return int(down.shape[0])

    def _propagate_and_deskew(self, pts, pt_time, imu_t, acc, gyr,
                              last_end_rel, pcl_end_rel):
        """IMU_Processing.hpp:216-346: propagate through every IMU interval
        that ends after the last scan's end, then to the scan's end, and
        bring each point to the scan-end frame."""
        x, P = self.x, self.P
        knots = [(0.0, x["rot"], x["pos"], x["vel"], self.acc_s_last,
                  self.angvel_last)]
        acc_avr = gyr_avr = torch.zeros(3, dtype=self.dtype,
                                        device=self.device)
        t_host = imu_t.tolist()
        for k in range(len(t_host) - 1):
            head, tail = t_host[k], t_host[k + 1]
            if tail < last_end_rel:
                continue
            gyr_avr = 0.5 * (gyr[k] + gyr[k + 1])
            acc_avr = 0.5 * (acc[k] + acc[k + 1]) * self.acc_scale
            dt = max(tail - max(head, last_end_rel), 0.0)
            x_pre = x
            x, P = predict(x, P, dt, self.Q, acc_avr, gyr_avr)
            self.angvel_last = gyr_avr - x["bg"]
            self.acc_s_last = qmat(x["rot"]) @ (acc_avr - x_pre["ba"]) + \
                x_pre["grav"]
            knots.append((tail, x["rot"], x["pos"], x["vel"],
                          self.acc_s_last, self.angvel_last))
        dt = pcl_end_rel - (t_host[-1] if t_host else 0.0)
        x, P = predict(x, P, dt, self.Q, acc_avr, gyr_avr)
        self.x, self.P = x, P
        if self.cfg["lidar_type"] == MARSIM or pts.shape[0] == 0:
            return pts
        kt = self._t([k[0] for k in knots])
        k_rot, k_pos, k_vel, k_acc, k_gyr = (
            torch.stack([k[i] for k in knots]) for i in range(1, 6))
        n_k = len(knots)
        head = (torch.searchsorted(kt, pt_time, right=False) - 1).clamp(
            0, n_k - 1)
        tail = (head + 1).clamp_max(n_k - 1)
        dtp = (pt_time - kt[head])[:, None]
        R_i = qmat(qmul(k_rot[head], qexp(k_gyr[tail] * dtp)))
        T_ei = (k_pos[head] + k_vel[head] * dtp
                + 0.5 * k_acc[tail] * dtp * dtp - x["pos"])
        R_ext = qmat(x["offR"])
        p_imu = pts @ R_ext.T + x["offT"]
        p_w = (R_i @ p_imu[:, :, None])[..., 0] + T_ei
        p_e = p_w @ qmat(x["rot"])  # R_end^T p
        return (p_e - x["offT"]) @ R_ext

    def _fov_segment(self):
        """laserMapping.cpp:231-277: slide the cube when the LiDAR nears a
        face; the map is pruned to the new cube whenever it moved."""
        cube = float(self.cfg["cube_side_length"])
        det = float(self.cfg["det_range"])
        x = self.x
        pos_lid = x["pos"] + qmat(x["rot"]) @ x["offT"]
        if not self.lm_init:
            lo, hi = pos_lid - cube / 2.0, pos_lid + cube / 2.0
            moved = True
        else:
            d_lo = (pos_lid - self.lm_lo).abs()
            d_hi = (pos_lid - self.lm_hi).abs()
            thr = MOV_THRESHOLD * det
            mov = max((cube - 2.0 * MOV_THRESHOLD * det) * 0.5 * 0.9,
                      det * (MOV_THRESHOLD - 1.0))
            shift = torch.where(d_lo <= thr, torch.full_like(d_lo, -mov),
                                torch.where(d_hi <= thr,
                                            torch.full_like(d_hi, mov),
                                            torch.zeros_like(d_hi)))
            lo, hi = self.lm_lo + shift, self.lm_hi + shift
            moved = bool((shift != 0).any())
        self.lm_lo, self.lm_hi, self.lm_init = lo, hi, True
        if moved:
            self.map.prune(lo, hi)

    def _downsample(self, pts):
        """The centroid of each occupied voxel of side filter_size_surf,
        voxels in ascending (x, y, z) order, the first n_ds_max."""
        if pts.shape[0] == 0:
            return pts
        leaf = float(self.cfg["filter_size_surf"])
        keys = cell_keys(torch.floor(pts / leaf))
        ks, order = torch.sort(keys, stable=True)
        uniq, inv = torch.unique_consecutive(ks, return_inverse=True)
        n_out = min(uniq.numel(), int(self.cfg["n_ds_max"]))
        sums = pts.new_zeros((uniq.numel(), 3)).index_add_(0, inv, pts[order])
        cnt = pts.new_zeros(uniq.numel()).index_add_(
            0, inv, torch.ones_like(inv, dtype=pts.dtype))
        return (sums / cnt[:, None])[:n_out]

    @staticmethod
    def _to_world(x, pts):
        R = qmat(x["rot"]) @ qmat(x["offR"])
        return pts @ R.T + (qmat(x["rot"]) @ x["offT"] + x["pos"])

    def _knn(self, q):
        cfg = self.cfg
        nbrs, sq, found = self.map.knn(q, wide=False)
        if not cfg["knn_wide_fallback"]:
            return nbrs, sq, found
        rcov2 = (0.5 * self.cell) ** 2
        unsat = ~found[:, -1] | (sq[:, -1] > rcov2)
        n_unsat = int(unsat.sum())
        if n_unsat == 0:
            return nbrs, sq, found
        K_w, N = int(cfg["knn_wide_max_queries"]), int(cfg["n_ds_max"])
        if n_unsat > (K_w if 0 < K_w < N else 0):
            unsat = torch.ones_like(unsat)
        w_nbrs, w_sq, w_found = self.map.knn(q, wide=True)
        u = unsat[:, None]
        return (torch.where(u[..., None], w_nbrs, nbrs),
                torch.where(u, w_sq, sq), torch.where(u, w_found, found))

    def _update(self, down):
        """The iterated point-to-plane update (esekfom.hpp:1619-1931 in the
        information form; laserMapping.cpp:638-754 for the measurement).
        Returns the neighbours of the last search, which the insert reads."""
        cfg = self.cfg
        max_iter = int(cfg["max_iteration"])
        epsi = self._t(cfg["epsi"])
        R_meas = float(cfg["laser_point_cov"])
        x_prop, P_prop = self.x, self.P
        x = x_prop
        N = down.shape[0]
        dev, dt = self.device, self.dtype
        nbrs = down.new_zeros((N, NUM_MATCH, 3))
        found = torch.zeros((N, NUM_MATCH), dtype=torch.bool, device=dev)
        selected = torch.zeros(N, dtype=torch.bool, device=dev)
        pabcd = down.new_zeros((N, 4))
        plane_ok = torch.zeros(N, dtype=torch.bool, device=dev)
        body_norm = torch.linalg.norm(down, dim=-1)
        eye = torch.eye(DOF, dtype=dt, device=dev)
        converge, t, any_valid = True, 0, False
        self.passes = 0
        P_post, dx_final = P_prop, down.new_zeros(DOF)
        for i in range(-1, max_iter):
            self.passes += 1
            p_w = self._to_world(x, down)
            if converge:
                nbrs, sq, found = self._knn(p_w)
                selected = found.all(-1) & (sq[:, -1] <= MAX_NN_SQ)
                pabcd, plane_ok = fit_planes(nbrs, found)
            pd2 = (pabcd[:, :3] * p_w).sum(-1) + pabcd[:, 3]
            s = 1.0 - 0.9 * pd2.abs() / torch.sqrt(body_norm.clamp_min(1e-9))
            selected = selected & plane_ok & (s > S_GATE)
            if not bool(selected.any()):
                if i == max_iter - 1:
                    break
                continue
            R = qmat(x["rot"])
            n = pabcd[:, :3]
            C = n @ R  # rows R^T n
            R_ext = qmat(x["offR"])
            p_imu = down @ R_ext.T + x["offT"]
            A = torch.linalg.cross(p_imu, C)
            if cfg["extrinsic_est_en"]:
                B = torch.linalg.cross(down, C @ R_ext)
            else:
                B = torch.zeros_like(A)
            m = selected.to(dt)[:, None]
            H = torch.cat([n, A, B, C], -1) * m
            h = -pd2 * m[:, 0]
            HTH = H.T @ H
            HTh = H.T @ h
            dx = boxminus(x, x_prop)
            T = transport(dx, x, x_prop)
            dx_new = T @ dx
            P_w = T @ P_prop @ T.T
            P_temp = self._spd_inv(P_w / R_meas)
            P_temp[:12, :12] += HTH
            P_inv = self._spd_inv(P_temp)
            dx_ = P_inv[:, :12] @ HTh + P_inv[:, :12] @ HTH @ dx_new[:12] \
                - dx_new
            x = boxplus(x, dx_)
            any_valid = True
            P_post, dx_final = R_meas * P_inv, dx_
            converged = bool((dx_.abs() <= epsi).all())
            t += int(converged)
            converge = converged or (t == 0 and i == max_iter - 2)
            if t > 1 or i == max_iter - 1:
                break
        self.x = x
        if any_valid:
            T = transport(dx_final, x, x_prop)
            P = T @ P_post @ T.T
            self.P = 0.5 * (P + P.T)
        return nbrs, found

    def _spd_inv(self, A):
        """The inverse of a symmetric positive definite matrix, its diagonal
        raised first by 32 epsilon of the configuration's compute type
        times its mean diagonal entry: the port's regularisation of the
        update's two solves, which in float32 moves the covariance of the
        weakly observed directions (velocity, biases) by tens of percent
        and in float64 by nothing measurable."""
        A = 0.5 * (A + A.T)
        eps = torch.finfo(getattr(torch, self.cfg["compute_dtype"])).eps
        jitter = 32.0 * eps * torch.trace(A) / A.shape[0]
        return torch.linalg.inv(A + jitter * torch.eye(
            A.shape[0], dtype=A.dtype, device=A.device))

    def _insert_decisions(self, world, nbrs, found, ekf_inited: bool):
        """laserMapping.cpp:433-467: add with the voxel downsample where the
        point has no neighbours yet (or the filter is not inited); add
        without it where the nearest neighbour lies outside the point's
        voxel on every axis; skip where one of the five is nearer the voxel
        centre than the point."""
        v = self.voxel
        mid = torch.floor(world / v) * v + 0.5 * v
        dist = ((world - mid) ** 2).sum(-1)
        have = found[:, 0] & bool(ekf_inited)
        far = ((nbrs[:, 0] - mid).abs() > 0.5 * v).all(-1)
        nd = ((nbrs - mid[:, None]) ** 2).sum(-1)
        nd = torch.where(found, nd, torch.full_like(nd, math.inf))
        blocked = found.all(-1) & (nd < dist[:, None]).any(-1)
        add = torch.where(have, far | ~blocked, torch.ones_like(have))
        ds = torch.where(have, ~far, torch.ones_like(have))
        return add, ds


def _mat_to_quat(R):
    w = math.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-8:
        return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                         (R[0, 2] - R[2, 0]) / (4 * w),
                         (R[1, 0] - R[0, 1]) / (4 * w)])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(0.0, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = s / 4
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q

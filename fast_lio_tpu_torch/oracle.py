"""Reference-faithful float64 NumPy oracle of the FAST-LIO2 pipeline.

A copy of ``fast_lio_tpu/oracle.py`` (importing that module would pull in
JAX through ``fast_lio_tpu/__init__.py``); its only change is that
``.config`` is the port's.  It consumes the port's ``ScanPacket`` (the same
fields as the JAX package's).  tests/test_torch_oracle.py holds the two
oracles bit-equal on the same packets, and holds the port's pipeline, in
float32 and float64, to it.

The reference's de-facto validation is rosbag replay judged by eye
(SURVEY.md §4); this module is an INDEPENDENT, sequential, float64 NumPy
implementation of the reference's exact math.  Nothing here shares code
with either pipeline — different array layout, different control flow,
written directly from the C++:

  * process model f / df_dx / df_dw        use-ikfom.hpp:47-88
  * manifold boxplus/boxminus/oplus        SOn.hpp:233-297, S2.hpp:97-310,
                                           mtkmath.hpp:142-288
  * predict                                esekfom.hpp:279-383
  * update_iterated_dyn_share_modified     esekfom.hpp:1619-1931
  * h_share_model (kNN + esti_plane + H)   laserMapping.cpp:638-754,
                                           common_lib.h:225-257
  * IMU init / forward prop / deskew       IMU_Processing.hpp:159-346
  * local-map cube + map_incremental       laserMapping.cpp:231-277,427-474
  * main-loop ordering                     laserMapping.cpp:865-1019

Two fidelity modes:

``quirks=True`` — bit-faithful to the reference INCLUDING its documented
accidents: the ``scalar(1/2)`` C++ integer divisions that collapse the
predict-step exp factors and the S2_Mx exp factor to identity
(esekfom.hpp:312,344; S2.hpp:280), the float32 ``esti_plane``/pd2/s
(laserMapping.cpp:677-683 use float locals), and the unbounded tree search.

``quirks=False`` — the mathematically intended variants the pipelines
implement (PARITY.md "known intentional deviations"): exp factors included,
float64 plane fit, optional orthogonal-regression fit and region-limited
kNN, so the oracle becomes "the pipeline's math in sequential f64" and
pins it to sub-mm/step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from .config import Config, LidarType

G_M_S2 = 9.81
S2_LEN = 98090.0 / 10000.0  # typedef MTK::S2<double, 98090, 10000, 1>
TOL = 1e-11  # MTK::tolerance<double>()
NUM_MATCH = 5
MAX_NN_SQ = 5.0
PLANE_THR = 0.1
MOV_THRESHOLD = 1.5

# error-state (DOF=23) block offsets, declaration order (use-ikfom.hpp:12-21)
POS, ROT, OFR, OFT, VEL, BG, BA, GRV = 0, 3, 6, 9, 12, 15, 18, 21


# --------------------------------------------------------------------------
# quaternions (w, x, y, z) and MTK math
# --------------------------------------------------------------------------

def quat_mult(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_rot(q, v):
    return quat_to_mat(q) @ v


def hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]],
                    dtype=np.float64)


def cos_sinc_sqrt(x2: float):
    """mtkmath.hpp:143-174 (boost epsilon Taylor bounds)."""
    eps = np.finfo(np.float64).eps
    taylor_n_bound = math.sqrt(math.sqrt(eps))
    if x2 >= taylor_n_bound:
        x = math.sqrt(x2)
        return math.cos(x), math.sin(x) / x
    inv = [1 / 3., 1 / 4., 1 / 5., 1 / 6., 1 / 7., 1 / 8., 1 / 9.]
    cosi, sinc = 1.0, 1.0
    term = -0.5 * x2
    for i in range(3):
        cosi += term
        term *= inv[2 * i]
        sinc += term
        term *= -inv[2 * i + 1] * x2
    return cosi, sinc


def mtk_exp(vec, scale: float):
    """MTK::exp (mtkmath.hpp:249-256): quaternion (w, s*sinc*vec)."""
    vec = np.asarray(vec, np.float64)
    c, s = cos_sinc_sqrt(scale * scale * float(vec @ vec))
    return np.concatenate([[c], s * scale * vec])


def so3_exp(vec, scale: float = 1.0):
    """SO3::exp (SOn.hpp:283-287): exp factor scale/2 (correct — the scale
    here is a C++ double, so no integer-division quirk)."""
    return mtk_exp(vec, scale / 2.0)


def so3_log(q):
    """SO3::log (SOn.hpp:292-296): MTK::log with scale 2, +/- periodicity."""
    w, vec = q[0], q[1:]
    nv = float(np.linalg.norm(vec))
    if nv < TOL:
        nv = TOL
    return (2.0 / nv) * math.atan(nv / w) * vec


def rodrigues(ang_vel, dt: float):
    """so3_math.h Exp(ang_vel, dt) — the deskew rotation (guard 1e-7)."""
    n = float(np.linalg.norm(ang_vel))
    if n <= 1e-7:
        return np.eye(3)
    K = hat(ang_vel / n)
    r = n * dt
    return np.eye(3) + math.sin(r) * K + (1.0 - math.cos(r)) * K @ K


def A_matrix(v):
    """mtkmath.hpp:236-247."""
    sq = float(v @ v)
    n = math.sqrt(sq)
    if n < TOL:
        return np.eye(3)
    hv = hat(v)
    return (np.eye(3) + (1 - math.cos(n)) / sq * hv
            + (1 - math.sin(n) / n) / sq * hv @ hv)


# --------------------------------------------------------------------------
# S2 (gravity) manifold, S2_typ=1, length 9.809  (S2.hpp:97-310)
# --------------------------------------------------------------------------

def s2_bx(vec):
    v0, v1, v2 = vec
    if v0 + S2_LEN > TOL:
        d = S2_LEN + v0
        res = np.array([
            [-v1, -v2],
            [S2_LEN - v1 * v1 / d, -v2 * v1 / d],
            [-v2 * v1 / d, S2_LEN - v2 * v2 / d],
        ])
        return res / S2_LEN
    res = np.zeros((3, 2))
    res[1, 1] = -1.0
    res[2, 0] = 1.0
    return res


def s2_boxplus(vec, delta2):
    Bu = s2_bx(vec) @ delta2
    return quat_to_mat(mtk_exp(Bu, 0.5)) @ vec


def s2_boxminus(vec, other):
    """this (=vec) boxminus other  (S2.hpp:144-167)."""
    v_sin = float(np.linalg.norm(hat(vec) @ other))
    v_cos = float(vec @ other)
    theta = math.atan2(v_sin, v_cos)
    if v_sin < TOL:
        if abs(theta) > TOL:
            return np.array([3.1415926, 0.0])
        return np.zeros(2)
    return theta / v_sin * (s2_bx(other).T @ (hat(other) @ vec))


def s2_nx_yy(vec):
    return (1.0 / (S2_LEN ** 2)) * (s2_bx(vec).T @ hat(vec))


def s2_mx(vec, delta2, quirks: bool):
    Bx = s2_bx(vec)
    if float(np.linalg.norm(delta2)) < TOL:
        return -hat(vec) @ Bx
    Bu = Bx @ delta2
    # reference: exp factor scalar(1/2) == 0 -> identity (S2.hpp:280)
    Rq = np.eye(3) if quirks else quat_to_mat(mtk_exp(Bu, 0.5))
    return -Rq @ hat(vec) @ A_matrix(Bu).T @ Bx


def s2_oplus(vec, delta3, scale: float):
    """S2::oplus (S2.hpp:129-134): scale here is a double -> scale/2 OK."""
    return quat_to_mat(mtk_exp(delta3, scale / 2.0)) @ vec


# --------------------------------------------------------------------------
# state
# --------------------------------------------------------------------------

@dataclasses.dataclass
class OState:
    pos: np.ndarray
    rot: np.ndarray  # quat (w,x,y,z)
    offset_R: np.ndarray  # quat
    offset_T: np.ndarray
    vel: np.ndarray
    bg: np.ndarray
    ba: np.ndarray
    grav: np.ndarray  # |grav| = 9.809

    @staticmethod
    def identity():
        return OState(
            pos=np.zeros(3), rot=np.array([1.0, 0, 0, 0]),
            offset_R=np.array([1.0, 0, 0, 0]), offset_T=np.zeros(3),
            vel=np.zeros(3), bg=np.zeros(3), ba=np.zeros(3),
            grav=np.array([S2_LEN, 0.0, 0.0]),  # S2_typ=1 default: len*e_x
        )

    def copy(self):
        return OState(*(np.array(getattr(self, f.name))
                        for f in dataclasses.fields(self)))

    def boxplus(self, dx):
        self.pos = self.pos + dx[POS:POS + 3]
        self.rot = quat_mult(self.rot, so3_exp(dx[ROT:ROT + 3]))
        self.offset_R = quat_mult(self.offset_R, so3_exp(dx[OFR:OFR + 3]))
        self.offset_T = self.offset_T + dx[OFT:OFT + 3]
        self.vel = self.vel + dx[VEL:VEL + 3]
        self.bg = self.bg + dx[BG:BG + 3]
        self.ba = self.ba + dx[BA:BA + 3]
        self.grav = s2_boxplus(self.grav, dx[GRV:GRV + 2])

    def boxminus(self, other) -> np.ndarray:
        dx = np.zeros(23)
        dx[POS:POS + 3] = self.pos - other.pos
        dx[ROT:ROT + 3] = so3_log(quat_mult(quat_conj(other.rot), self.rot))
        dx[OFR:OFR + 3] = so3_log(
            quat_mult(quat_conj(other.offset_R), self.offset_R))
        dx[OFT:OFT + 3] = self.offset_T - other.offset_T
        dx[VEL:VEL + 3] = self.vel - other.vel
        dx[BG:BG + 3] = self.bg - other.bg
        dx[BA:BA + 3] = self.ba - other.ba
        dx[GRV:GRV + 2] = s2_boxminus(self.grav, other.grav)
        return dx

    def oplus(self, f24, dt: float):
        """DIM-space retraction used by predict (build_manifold oplus)."""
        self.pos = self.pos + f24[0:3] * dt
        self.rot = quat_mult(self.rot, mtk_exp(f24[3:6], dt / 2.0))
        self.offset_R = quat_mult(self.offset_R, mtk_exp(f24[6:9], dt / 2.0))
        self.offset_T = self.offset_T + f24[9:12] * dt
        self.vel = self.vel + f24[12:15] * dt
        self.bg = self.bg + f24[15:18] * dt
        self.ba = self.ba + f24[18:21] * dt
        self.grav = s2_oplus(self.grav, f24[21:24], dt)


# --------------------------------------------------------------------------
# process model (use-ikfom.hpp:47-88)
# --------------------------------------------------------------------------

def get_f(s: OState, acc, gyr):
    f = np.zeros(24)
    omega = gyr - s.bg
    a_inertial = quat_rot(s.rot, acc - s.ba)
    f[0:3] = s.vel
    f[3:6] = omega
    f[12:15] = a_inertial + s.grav
    return f


def df_dx(s: OState, acc, gyr):
    cov = np.zeros((24, 23))
    cov[0:3, 12:15] = np.eye(3)
    R = quat_to_mat(s.rot)
    cov[12:15, 3:6] = -R @ hat(acc - s.ba)
    cov[12:15, 18:21] = -R
    cov[12:15, 21:23] = s2_mx(s.grav, np.zeros(2), quirks=False)  # delta=0
    cov[3:6, 15:18] = -np.eye(3)
    return cov


def df_dw(s: OState, acc, gyr):
    cov = np.zeros((24, 12))
    cov[12:15, 3:6] = -quat_to_mat(s.rot)
    cov[3:6, 0:3] = -np.eye(3)
    cov[15:18, 6:9] = np.eye(3)
    cov[18:21, 9:12] = np.eye(3)
    return cov


_VECT_BLOCKS = [(0, 0), (9, 9), (12, 12), (15, 15), (18, 18)]  # (idx, dim)
_SO3_BLOCKS = [(3, 3), (6, 6)]
_S2_IDX, _S2_DIM = 21, 21


def predict(x: OState, P, dt: float, Q, acc, gyr, quirks: bool):
    """esekfom.hpp:279-383."""
    f = get_f(x, acc, gyr)
    fx = df_dx(x, acc, gyr)
    fw = df_dw(x, acc, gyr)
    x_before = x.copy()
    x.oplus(f, dt)

    F_x1 = np.eye(23)
    fx_final = np.zeros((23, 23))
    fw_final = np.zeros((23, 12))
    for idx, dim in _VECT_BLOCKS:
        fx_final[idx:idx + 3, :] = fx[dim:dim + 3, :]
        fw_final[idx:idx + 3, :] = fw[dim:dim + 3, :]
    for idx, dim in _SO3_BLOCKS:
        seg = -f[dim:dim + 3] * dt
        # reference: exp factor scalar_type(1/2) == 0 -> identity
        # (esekfom.hpp:312); intended math uses the real factor
        F_x1[idx:idx + 3, idx:idx + 3] = (
            np.eye(3) if quirks else quat_to_mat(mtk_exp(seg, 0.5)))
        A = A_matrix(seg)
        fx_final[idx:idx + 3, :] = A @ fx[dim:dim + 3, :]
        fw_final[idx:idx + 3, :] = A @ fw[dim:dim + 3, :]
    # S2 block (grav)
    seg = f[_S2_DIM:_S2_DIM + 3] * dt
    Rexp = np.eye(3) if quirks else quat_to_mat(mtk_exp(seg, 0.5))
    Nx = s2_nx_yy(x.grav)  # x AFTER oplus (esekfom.hpp:348)
    Mx = s2_mx(x_before.grav, np.zeros(2), quirks)
    F_x1[_S2_IDX:_S2_IDX + 2, _S2_IDX:_S2_IDX + 2] = Nx @ Rexp @ Mx
    res2 = -Nx @ Rexp @ hat(x_before.grav) @ A_matrix(seg).T
    fx_final[_S2_IDX:_S2_IDX + 2, :] = res2 @ fx[_S2_DIM:_S2_DIM + 3, :]
    fw_final[_S2_IDX:_S2_IDX + 2, :] = res2 @ fw[_S2_DIM:_S2_DIM + 3, :]

    F = F_x1 + fx_final * dt
    Fw = dt * fw_final
    return x, F @ P @ F.T + Fw @ Q @ Fw.T


def update_iterated(x: OState, P, h_share, R: float, max_iter: int,
                    epsi: float, quirks: bool):
    """esekfom.hpp:1619-1931 (modified dyn-share update, dense 23x23 form;
    the N<23 branch is algebraically identical and unused at LIO scales)."""
    x_prop = x.copy()
    P_prop = P.copy()
    converge = True
    t = 0
    for i in range(-1, max_iter):
        valid, h_x, h = h_share(x, converge)
        if not valid:
            continue
        dx = x.boxminus(x_prop)
        dx_new = dx.copy()
        P = P_prop.copy()
        for idx, _ in _SO3_BLOCKS:
            At = A_matrix(dx[idx:idx + 3]).T
            dx_new[idx:idx + 3] = At @ dx_new[idx:idx + 3]
            P[idx:idx + 3, :] = At @ P[idx:idx + 3, :]
            P[:, idx:idx + 3] = P[:, idx:idx + 3] @ At.T
        NM = s2_nx_yy(x.grav) @ s2_mx(x_prop.grav, dx[GRV:GRV + 2], quirks)
        dx_new[GRV:GRV + 2] = NM @ dx_new[GRV:GRV + 2]
        P[GRV:GRV + 2, :] = NM @ P[GRV:GRV + 2, :]
        P[:, GRV:GRV + 2] = P[:, GRV:GRV + 2] @ NM.T

        HTH = h_x.T @ h_x  # (12,12): the ONLY reductions over rows
        P_temp = np.linalg.inv(P / R)
        P_temp[:12, :12] += HTH
        P_inv = np.linalg.inv(P_temp)
        K_h = P_inv[:, :12] @ (h_x.T @ h)
        K_x = np.zeros((23, 23))
        K_x[:, :12] = P_inv[:, :12] @ HTH

        dx_ = K_h + (K_x - np.eye(23)) @ dx_new
        x.boxplus(dx_)
        converge = bool(np.all(np.abs(dx_) < epsi))
        if converge:
            t += 1
        if t == 0 and i == max_iter - 2:  # force re-search before last iter
            converge = True
        if t > 1 or i == max_iter - 1:
            L = P.copy()
            for idx, _ in _SO3_BLOCKS:
                At = A_matrix(dx_[idx:idx + 3]).T
                L[idx:idx + 3, :] = At @ P[idx:idx + 3, :]
                K_x[idx:idx + 3, :12] = At @ K_x[idx:idx + 3, :12]
                L[:, idx:idx + 3] = L[:, idx:idx + 3] @ At.T
                P[:, idx:idx + 3] = P[:, idx:idx + 3] @ At.T
            NM = s2_nx_yy(x.grav) @ s2_mx(x_prop.grav, dx_[GRV:GRV + 2],
                                          quirks)
            L[GRV:GRV + 2, :] = NM @ P[GRV:GRV + 2, :]
            K_x[GRV:GRV + 2, :12] = NM @ K_x[GRV:GRV + 2, :12]
            L[:, GRV:GRV + 2] = L[:, GRV:GRV + 2] @ NM.T
            P[:, GRV:GRV + 2] = P[:, GRV:GRV + 2] @ NM.T
            return x, L - K_x[:, :12] @ P[:12, :]
    return x, P


# --------------------------------------------------------------------------
# plane fits (common_lib.h:225-257; ops/plane_fit.py variant)
# --------------------------------------------------------------------------

def esti_plane_ref(points, threshold=PLANE_THR, f32=True):
    """Unit-RHS least squares exactly as the reference (called with
    T=float from h_share_model, laserMapping.cpp:677)."""
    dt = np.float32 if f32 else np.float64
    A = np.asarray(points, dt)
    b = -np.ones(len(points), dt)
    nv, *_ = np.linalg.lstsq(A, b, rcond=None)  # solved in dt precision
    nv = nv.astype(dt)
    n = dt(np.linalg.norm(nv.astype(np.float64)))
    if n == 0:
        return None
    pabcd = np.array([nv[0] / n, nv[1] / n, nv[2] / n, dt(1.0) / n], dt)
    for p in A:
        if abs(dt(pabcd[0] * p[0] + pabcd[1] * p[1] + pabcd[2] * p[2]
                  + pabcd[3])) > threshold:
            return None
    return pabcd.astype(np.float64)


def esti_plane_orth(points, threshold=PLANE_THR):
    """Centered orthogonal regression — the TPU pipeline's documented
    variant (ops/plane_fit.py)."""
    pts = np.asarray(points, np.float64)
    c = pts.mean(0)
    A = pts - c
    _, _, vt = np.linalg.svd(A, full_matrices=False)
    n = vt[-1]
    d = -n @ c
    if np.any(np.abs(pts @ n + d) > threshold):
        return None
    return np.array([n[0], n[1], n[2], d])


# --------------------------------------------------------------------------
# the oracle pipeline
# --------------------------------------------------------------------------

class OracleMap:
    """Reference map semantics: unbounded kNN (ikd-Tree Nearest_Search) by
    brute force, Add_Points with on-tree voxel downsample (keep the point
    nearest the voxel center, evicting in-voxel points it beats), lazy
    box-delete via the local-map cube."""

    def __init__(self, voxel: float, f32_storage: bool):
        self.voxel = voxel
        self.dt = np.float32 if f32_storage else np.float64
        self.voxels = {}  # (i,j,k) -> list of points in that voxel
        self._pts = np.zeros((0, 3), self.dt)
        self._dirty = False

    @property
    def pts(self):
        if self._dirty:
            all_pts = [p for lst in self.voxels.values() for p in lst]
            self._pts = (np.asarray(all_pts, self.dt) if all_pts
                         else np.zeros((0, 3), self.dt))
            self._dirty = False
        return self._pts

    def size(self):
        return len(self.pts)

    def knn(self, q, k=NUM_MATCH):
        if len(self.pts) == 0:
            return np.zeros((0, 3)), np.zeros(0)
        d2 = ((self.pts.astype(np.float64) - q) ** 2).sum(-1)
        idx = np.argsort(d2, kind="stable")[:k]
        return self.pts[idx].astype(np.float64), d2[idx]

    def knn_batch(self, qs, k=NUM_MATCH):
        """Vectorized brute-force kNN for a query block (chunked)."""
        if len(self.pts) == 0:
            return ([np.zeros((0, 3))] * len(qs),
                    [np.zeros(0)] * len(qs))
        mp = self.pts.astype(np.float64)
        near, sqs = [], []
        for s in range(0, len(qs), 512):
            q = np.asarray(qs[s:s + 512], np.float64)
            d2 = ((q[:, None, :] - mp[None, :, :]) ** 2).sum(-1)
            kk = min(k, d2.shape[1])
            idx = np.argpartition(d2, kth=kk - 1, axis=1)[:, :kk]
            dsel = np.take_along_axis(d2, idx, axis=1)
            o = np.argsort(dsel, axis=1, kind="stable")
            idx = np.take_along_axis(idx, o, axis=1)
            dsel = np.take_along_axis(dsel, o, axis=1)
            for r in range(len(q)):
                near.append(mp[idx[r]])
                sqs.append(dsel[r])
        return near, sqs

    def _vox(self, p):
        return np.floor(np.asarray(p, np.float64) / self.voxel).astype(np.int64)

    def add(self, pts, downsample: bool):
        """ikd-Tree Add_Points semantics (voxel-dict indexed)."""
        if len(pts) == 0:
            return
        pts = np.asarray(pts, self.dt)
        self._dirty = True
        if not downsample:
            for p in pts:
                self.voxels.setdefault(tuple(self._vox(p)), []).append(p)
            return
        for p in pts:
            v = self._vox(p)
            key = tuple(v)
            mid = (v + 0.5) * self.voxel
            lst = self.voxels.get(key)
            d_new = float(((p.astype(np.float64) - mid) ** 2).sum())
            if lst:
                d_old = min(float(((q.astype(np.float64) - mid) ** 2).sum())
                            for q in lst)
                if d_old <= d_new:
                    continue  # incumbent wins, drop the new point
            self.voxels[key] = [p]  # evict in-voxel points, keep winner

    def prune_outside(self, lo, hi):
        self._dirty = True
        new = {}
        for key, lst in self.voxels.items():
            kept = [p for p in lst
                    if np.all(p >= lo) and np.all(p <= hi)]
            if kept:
                new[key] = kept
        self.voxels = new


class OracleLIO:
    """Sequential reference pipeline; consumes pipeline.ScanPacket."""

    def __init__(self, cfg: Config, quirks: bool = True,
                 plane_fit: str = None, knn: str = None):
        self.cfg = cfg
        self.quirks = quirks
        self.plane_fit = plane_fit or ("reference" if quirks else "orthogonal")
        self.knn_mode = knn or "unbounded"
        self.x = OState.identity()
        self.P = np.eye(23)
        self.Q = np.zeros((12, 12))
        self.Q[0:3, 0:3] = np.eye(3) * cfg.gyr_cov
        self.Q[3:6, 3:6] = np.eye(3) * cfg.acc_cov
        self.Q[6:9, 6:9] = np.eye(3) * cfg.b_gyr_cov
        self.Q[9:12, 9:12] = np.eye(3) * cfg.b_acc_cov
        self.map = OracleMap(cfg.filter_size_map, f32_storage=quirks)

        # IMU init accumulators (IMU_Processing.hpp:159-214)
        self.init_n = 1
        self.first_frame = True
        self.mean_acc = np.zeros(3)
        self.mean_gyr = np.zeros(3)
        self.need_init = True
        self.last_imu: Optional[tuple] = None
        self.last_lidar_end = 0.0
        self.angvel_last = np.zeros(3)
        self.acc_s_last = np.zeros(3)
        self.first_lidar_time: Optional[float] = None
        self.map_built = False
        self.lm_lo = None
        self.lm_hi = None
        self.trajectory: List[tuple] = []
        # h_share caches (Nearest_Points / point_selected_surf)
        self._near: List[np.ndarray] = []
        self._sel: np.ndarray = np.zeros(0, bool)

    # ---- IMU ----

    def _imu_init(self, pkt):
        if self.first_frame:
            self.init_n = 1
            self.first_frame = False
            self.mean_acc = np.array(pkt.imu_acc[0], np.float64)
            self.mean_gyr = np.array(pkt.imu_gyr[0], np.float64)
            self.first_lidar_time = pkt.lidar_beg_time
        for a, g in zip(pkt.imu_acc, pkt.imu_gyr):
            N = self.init_n
            self.mean_acc += (np.asarray(a, np.float64) - self.mean_acc) / N
            self.mean_gyr += (np.asarray(g, np.float64) - self.mean_gyr) / N
            self.init_n += 1
        # state init (IMU_Processing.hpp:196-211); S2 ctor renormalizes to
        # length 9.809 regardless of G_m_s2
        g = -self.mean_acc / np.linalg.norm(self.mean_acc) * G_M_S2
        self.x.grav = g / np.linalg.norm(g) * S2_LEN
        self.x.bg = self.mean_gyr.copy()
        self.x.offset_T = np.asarray(self.cfg.extrinsic_T_vec, np.float64)
        Rm = np.asarray(self.cfg.extrinsic_R_mat, np.float64)
        self.x.offset_R = _mat_to_quat(Rm)
        P = np.eye(23)
        P[6:9, 6:9] *= 1e-5
        P[9:12, 9:12] *= 1e-5
        P[15:18, 15:18] *= 1e-4
        P[18:21, 18:21] *= 1e-3
        P[21:23, 21:23] *= 1e-5
        self.P = P
        self.last_imu = (pkt.imu_t[-1], np.array(pkt.imu_acc[-1]),
                         np.array(pkt.imu_gyr[-1]))
        if self.init_n > self.cfg.max_ini_count:
            self.need_init = False

    def _undistort(self, pkt):
        """UndistortPcl (IMU_Processing.hpp:216-346).  The packet's IMU block
        already includes the previous frame's tail sample (SyncBuffer)."""
        imu_t = np.asarray(pkt.imu_t, np.float64)
        imu_acc = np.asarray(pkt.imu_acc, np.float64)
        imu_gyr = np.asarray(pkt.imu_gyr, np.float64)
        pcl_beg = pkt.lidar_beg_time
        pcl_end = pkt.lidar_end_time
        if self.cfg.lidar_type == LidarType.MARSIM:
            pcl_beg = self.last_lidar_end
            pcl_end = pkt.lidar_beg_time

        order = np.argsort(pkt.pt_time, kind="stable")
        pts = np.asarray(pkt.pts, np.float64)[order]
        tp = np.asarray(pkt.pt_time, np.float64)[order]

        knots = [(0.0, self.acc_s_last.copy(), self.angvel_last.copy(),
                  self.x.vel.copy(), self.x.pos.copy(),
                  quat_to_mat(self.x.rot))]
        acc_avr = np.zeros(3)
        gyr_avr = np.zeros(3)
        for k in range(len(imu_t) - 1):
            th, tt = imu_t[k], imu_t[k + 1]
            if tt < self.last_lidar_end:
                continue
            gyr_avr = 0.5 * (imu_gyr[k] + imu_gyr[k + 1])
            acc_avr = 0.5 * (imu_acc[k] + imu_acc[k + 1])
            acc_avr = acc_avr * G_M_S2 / np.linalg.norm(self.mean_acc)
            dt = tt - (self.last_lidar_end if th < self.last_lidar_end else th)
            self.x, self.P = predict(self.x, self.P, dt, self.Q, acc_avr,
                                     gyr_avr, self.quirks)
            self.angvel_last = gyr_avr - self.x.bg
            self.acc_s_last = quat_rot(self.x.rot, acc_avr - self.x.ba) \
                + self.x.grav
            knots.append((tt - pcl_beg, self.acc_s_last.copy(),
                          self.angvel_last.copy(), self.x.vel.copy(),
                          self.x.pos.copy(), quat_to_mat(self.x.rot)))
        imu_end = imu_t[-1]
        note = 1.0 if pcl_end > imu_end else -1.0
        dt = note * (pcl_end - imu_end)
        self.x, self.P = predict(self.x, self.P, dt, self.Q, acc_avr,
                                 gyr_avr, self.quirks)
        self.last_lidar_end = pcl_end

        if self.cfg.lidar_type == LidarType.MARSIM or len(pts) == 0:
            return pts

        # backward pass (:307-345)
        R_ext = quat_to_mat(self.x.offset_R)
        T_ext = self.x.offset_T
        R_end_T = quat_to_mat(self.x.rot).T
        pos_end = self.x.pos
        out = pts.copy()
        i = len(pts) - 1
        for k in range(len(knots) - 1, 0, -1):
            head = knots[k - 1]
            tail = knots[k]
            t_head, _, _, vel_h, pos_h, R_h = head
            _, acc_t, gyr_t, _, _, _ = tail
            while i >= 0 and tp[i] > t_head:
                dt = tp[i] - t_head
                R_i = R_h @ rodrigues(gyr_t, dt)
                T_ei = pos_h + vel_h * dt + 0.5 * acc_t * dt * dt - pos_end
                p = pts[i]
                out[i] = R_ext.T @ (
                    R_end_T @ (R_i @ (R_ext @ p + T_ext) + T_ei) - T_ext)
                i -= 1
            if i < 0:
                break
        return out

    # ---- per-scan pipeline (main-loop ordering, laserMapping.cpp:865-1019)

    def process_packet(self, pkt):
        if self.first_lidar_time is None:
            self.first_lidar_time = pkt.lidar_beg_time
        if len(pkt.imu_t) == 0:
            return
        if self.need_init:
            self._imu_init(pkt)
            self.last_lidar_end = pkt.lidar_end_time
            return

        feats = self._undistort(pkt)
        if len(feats) == 0:
            return
        ekf_inited = (pkt.lidar_beg_time - self.first_lidar_time
                      ) >= self.cfg.init_time

        self._fov_segment()
        down_body = _voxel_centroids(feats, self.cfg.filter_size_surf)

        if not self.map_built:
            if len(down_body) > 5:
                self.map.add(self._to_world(down_body), downsample=True)
                self.map_built = True
            return
        if len(down_body) < 5:
            return

        n = len(down_body)
        self._near = [np.zeros((0, 3)) for _ in range(n)]
        self._sel = np.zeros(n, bool)
        self._normvec = np.zeros((n, 4))
        self._pd2 = np.zeros(n)

        def h_share(x, converge):
            return self._h_share(x, converge, down_body)

        self.x, self.P = update_iterated(
            self.x, self.P, h_share, self.cfg.laser_point_cov,
            self.cfg.max_iteration, self.cfg.epsi, self.quirks)

        self._map_incremental(down_body, ekf_inited)
        self.trajectory.append(
            (pkt.lidar_end_time, self.x.pos.copy(), self.x.rot.copy()))

    def _to_world(self, pts_body):
        R = quat_to_mat(self.x.rot)
        Re = quat_to_mat(self.x.offset_R)
        return (R @ (Re @ pts_body.T + self.x.offset_T[:, None])).T + self.x.pos

    def _h_share(self, x: OState, converge: bool, down_body):
        R = quat_to_mat(x.rot)
        Re = quat_to_mat(x.offset_R)
        rows, hs = [], []
        if self.plane_fit == "reference":
            fit = lambda p: esti_plane_ref(p, f32=self.quirks)
        else:
            fit = esti_plane_orth
        pw_all = (R @ (Re @ np.asarray(down_body).T
                       + x.offset_T[:, None])).T + x.pos
        if converge:
            near_all, sq_all = self.map.knn_batch(pw_all)
        for i, pb in enumerate(down_body):
            pw = pw_all[i]
            if converge:
                near, sq = near_all[i], sq_all[i]
                self._near[i] = near
                self._sel[i] = not (len(near) < NUM_MATCH
                                    or sq[NUM_MATCH - 1] > MAX_NN_SQ)
            if not self._sel[i]:
                continue
            self._sel[i] = False
            pabcd = fit(self._near[i])
            if pabcd is None:
                continue
            if self.quirks:  # float pd2 / s locals (laserMapping.cpp:680-683)
                pd2 = np.float32(pabcd[0] * pw[0] + pabcd[1] * pw[1]
                                 + pabcd[2] * pw[2] + pabcd[3])
                s = np.float32(1.0) - np.float32(0.9) * np.float32(
                    abs(pd2)) / np.float32(math.sqrt(np.linalg.norm(pb)))
            else:
                pd2 = pabcd[0] * pw[0] + pabcd[1] * pw[1] + pabcd[2] * pw[2] \
                    + pabcd[3]
                s = 1.0 - 0.9 * abs(pd2) / math.sqrt(np.linalg.norm(pb))
            if s > 0.9:
                self._sel[i] = True
                self._normvec[i] = pabcd
                self._pd2[i] = pd2
        for i, pb in enumerate(down_body):
            if not self._sel[i]:
                continue
            nvec = self._normvec[i, :3]
            C = R.T @ nvec
            p_imu = Re @ pb + x.offset_T
            A = hat(p_imu) @ C
            if self.cfg.extrinsic_est_en:
                B = hat(pb) @ (Re.T @ C)
            else:
                B = np.zeros(3)
            rows.append(np.concatenate([nvec, A, B, C]))
            hs.append(-self._pd2[i])
        if not rows:
            return False, None, None
        return True, np.asarray(rows), np.asarray(hs)

    def _fov_segment(self):
        pos_lid = self.x.pos + quat_rot(self.x.rot, self.x.offset_T)
        cube = self.cfg.cube_side_length
        det = self.cfg.det_range
        if self.lm_lo is None:
            self.lm_lo = pos_lid - cube / 2.0
            self.lm_hi = pos_lid + cube / 2.0
            return
        d_lo = np.abs(pos_lid - self.lm_lo)
        d_hi = np.abs(pos_lid - self.lm_hi)
        thr = MOV_THRESHOLD * det
        if not (np.any(d_lo <= thr) or np.any(d_hi <= thr)):
            return
        mov = max((cube - 2.0 * MOV_THRESHOLD * det) * 0.5 * 0.9,
                  det * (MOV_THRESHOLD - 1.0))
        shift = np.where(d_lo <= thr, -mov, np.where(d_hi <= thr, mov, 0.0))
        self.lm_lo = self.lm_lo + shift
        self.lm_hi = self.lm_hi + shift
        self.map.prune_outside(self.lm_lo, self.lm_hi)

    def _map_incremental(self, down_body, ekf_inited):
        """laserMapping.cpp:427-474."""
        world = self._to_world(down_body)
        to_add, no_ds = [], []
        vox = self.cfg.filter_size_map
        for i, pw in enumerate(world):
            near = self._near[i]
            if len(near) and ekf_inited:
                mid = np.floor(pw / vox) * vox + 0.5 * vox
                dist = ((pw - mid) ** 2).sum()
                if np.all(np.abs(near[0] - mid) > 0.5 * vox):
                    no_ds.append(pw)
                    continue
                need_add = True
                if len(near) >= NUM_MATCH:
                    for j in range(NUM_MATCH):
                        if ((near[j] - mid) ** 2).sum() < dist:
                            need_add = False
                            break
                if need_add:
                    to_add.append(pw)
            else:
                to_add.append(pw)
        self.map.add(np.asarray(to_add).reshape(-1, 3), downsample=True)
        self.map.add(np.asarray(no_ds).reshape(-1, 3), downsample=False)


def _mat_to_quat(R):
    w = math.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-8:
        return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                         (R[0, 2] - R[2, 0]) / (4 * w),
                         (R[1, 0] - R[0, 1]) / (4 * w)])
    # fall back: largest diagonal
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(0.0, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = s / 4
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _voxel_centroids(pts, leaf):
    """PCL VoxelGrid semantics: centroid per occupied voxel, output ordered
    by voxel key (PCL sorts by leaf index)."""
    v = np.floor(pts / leaf).astype(np.int64)
    key = (v - v.min(0)).astype(np.int64)
    k = (key[:, 0] << 42) | (key[:, 1] << 21) | key[:, 2]
    order = np.argsort(k, kind="stable")
    ks = k[order]
    pts_s = pts[order]
    first = np.concatenate([[True], ks[1:] != ks[:-1]])
    seg = np.cumsum(first) - 1
    n_seg = seg[-1] + 1
    sums = np.zeros((n_seg, 3))
    np.add.at(sums, seg, pts_s)
    cnt = np.zeros(n_seg)
    np.add.at(cnt, seg, 1.0)
    return sums / cnt[:, None]

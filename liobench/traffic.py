"""The benchmark's traffic: a vehicle patrolling a closed route through a
campus of buildings, its LiDAR's raw driver messages and its IMU, one lap
cast once and replayed lap after lap, with noise drawn from the seed.

* The world (``World``) is fixed by the mix, not by the run's seed: flat
  ground over the route's surroundings, buildings on a grid of lots kept
  clear of the road, and poles along both kerbs, all axis-aligned boxes
  laid out from the mix's own ``world.seed``.  Every run drives the same
  campus, so a seed changes the noise and not the work.
* The route (``Route``) is a rounded rectangle around a block, periodic in
  a lap of a whole number of scan periods, with a small bob of the height;
  the vehicle starts at rest and ramps up before the first lap.  Its IMU
  (specific force and rate in the body frame) comes from the closed form.
* The sensors (``SENSORS``) give what their drivers publish: the Livox
  Avia's CustomMsg (a two-prism rosette of six lasers, every return and
  every miss as a zero point, ``offset_time`` in ns, ``tag``, ``line``)
  and the Ouster OS1's organised PointCloud2 (rows top beam first, a
  column's time ``t`` in ns).  Every ray is cast from the LiDAR's position
  at its own firing time, so a scan carries the motion that deskewing
  removes.  The messages go through the port's decoders like a recorded
  bag's.

The geometry (each ray's direction and clean range) is cast once, in
float64 on the run's device; each scan replayed then draws its range noise
(a window of a pool of normals drawn from the seed, at an offset drawn from
the seed) and each IMU sample its noise, on top of constant biases.  Stamps
keep counting, so the stream is one vehicle driving lap after lap.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

G = 9.81


@dataclasses.dataclass
class Route:
    """x = a cos(phi) + c cos(3 phi), y = b sin(phi) - c sin(3 phi): a
    rectangle of rounded corners for c about a / 8, driven anticlockwise,
    phi = 2 pi tau / lap_s with tau the time ramped from rest; the sensor's
    height bobs ``z_amp`` at ``z_harmonic`` times a lap."""

    a: float = 110.0
    b: float = 75.0
    c: float = 14.0
    lap_s: float = 60.0
    height: float = 1.9
    z_amp: float = 0.1
    z_harmonic: int = 3
    t_ramp_start: float = 0.5
    t_ramp: float = 1.5

    def _tau(self, t):
        u = np.clip((t - self.t_ramp_start) / self.t_ramp, 0.0, 1.0)
        b = u * u * u * (10.0 - 15.0 * u + 6.0 * u * u)
        return (t - self.t_ramp_start) * b, b

    def _phi(self, t):
        tau, b = self._tau(np.asarray(t, np.float64))
        return 2.0 * math.pi * tau / self.lap_s, b

    def xy(self, phi):
        a, b, c = self.a, self.b, self.c
        return np.stack([a * np.cos(phi) + c * np.cos(3 * phi),
                         b * np.sin(phi) - c * np.sin(3 * phi)], -1)

    def heading(self, phi):
        """The tangent's angle, unwrapped: phi + pi/2 and a bounded turn."""
        a, b, c = self.a, self.b, self.c
        dx = -a * np.sin(phi) - 3 * c * np.sin(3 * phi)
        dy = b * np.cos(phi) - 3 * c * np.cos(3 * phi)
        base = phi + 0.5 * math.pi
        d = np.arctan2(dy, dx) - base
        return base + (d + math.pi) % (2 * math.pi) - math.pi

    def pos(self, t):
        phi, b = self._phi(t)
        z = self.height + self.z_amp * np.sin(self.z_harmonic * phi) * b
        return np.concatenate([self.xy(phi), z[..., None]], -1)

    def yaw(self, t):
        return self.heading(self._phi(t)[0])

    def imu(self, t, h=1e-3):
        """Body-frame specific force and angular rate at times t, by central
        differences of the closed form (float64; the step keeps the
        rounding of positions a hundred metres out near 1e-8 m/s^2)."""
        t = np.asarray(t, np.float64)
        acc_w = (self.pos(t + h) - 2 * self.pos(t) + self.pos(t - h)) / (h * h)
        f_w = acc_w + np.array([0.0, 0.0, G])
        y = self.yaw(t)
        c, s = np.cos(y), np.sin(y)
        f_b = np.stack([c * f_w[..., 0] + s * f_w[..., 1],
                        -s * f_w[..., 0] + c * f_w[..., 1], f_w[..., 2]], -1)
        rate = (self.yaw(t + h) - self.yaw(t - h)) / (2 * h)
        w_b = np.stack([np.zeros_like(rate), np.zeros_like(rate), rate], -1)
        return f_b, w_b


class World:
    """Boxes (lo, hi) on ground at z = 0 that spans ``extent`` (x0, y0, x1,
    y1)."""

    def __init__(self, boxes: np.ndarray, extent: Tuple[float, ...]):
        self.boxes = np.asarray(boxes, np.float64).reshape(-1, 6)
        self.extent = tuple(float(v) for v in extent)

    def cast(self, origins, dirs, max_range: float):
        """Ranges of rays (N, 3) from ``origins`` (N, 3) or (3,): (range,
        hit), with the boxes that no ray can reach left out."""
        dev, dt = dirs.device, dirs.dtype
        o = origins.expand_as(dirs)
        inv = 1.0 / torch.where(dirs.abs() < 1e-12,
                                torch.full_like(dirs, 1e-12), dirs)
        best = torch.full(dirs.shape[:1], max_range + 1.0, dtype=dt,
                          device=dev)
        # the ground, inside the extent
        x0, y0, x1, y1 = self.extent
        tg = -o[:, 2] / torch.where(dirs[:, 2] < -1e-12, dirs[:, 2],
                                    torch.full_like(best, -1e-12))
        gp = o + tg[:, None] * dirs
        on = ((dirs[:, 2] < -1e-12) & (gp[:, 0] >= x0) & (gp[:, 0] <= x1)
              & (gp[:, 1] >= y0) & (gp[:, 1] <= y1))
        best = torch.where(on, torch.minimum(best, tg), best)
        centre = o.mean(0).cpu().numpy()
        spread = float((o - o.mean(0)).norm(dim=-1).max())
        mid = 0.5 * (self.boxes[:, :3] + self.boxes[:, 3:])
        half = 0.5 * np.linalg.norm(self.boxes[:, 3:] - self.boxes[:, :3],
                                    axis=1)
        near = np.linalg.norm(mid - centre, axis=1) - half < \
            max_range + spread
        if near.any():
            b = torch.as_tensor(self.boxes[near], dtype=dt, device=dev)
            t1 = (b[None, :, :3] - o[:, None]) * inv[:, None]
            t2 = (b[None, :, 3:] - o[:, None]) * inv[:, None]
            tn = torch.minimum(t1, t2).amax(-1)
            tf = torch.maximum(t1, t2).amin(-1)
            del t1, t2
            tn = torch.where((tn <= tf) & (tn > 1e-6), tn,
                             torch.full_like(tn, math.inf))
            best = torch.minimum(best, tn.amin(-1))
        return best, best <= max_range


def make_world(route: Route, spec: Dict) -> World:
    """The campus around ``route``: lots of ``lot`` m over the route's
    bounding box and ``margin`` m beyond, each holding a building with
    probability ``building_p`` (footprint and height drawn in their ranges,
    none within ``clear`` m of the road), and a pole every ``pole_every`` m
    of road at ``pole_offset`` m on each side.  Drawn from ``spec['seed']``
    alone."""
    rng = np.random.default_rng(int(spec["seed"]))
    phi = np.linspace(0.0, 2 * math.pi, 4096, endpoint=False)
    road = route.xy(phi)
    m = float(spec["margin"])
    x0, y0 = road.min(0) - m
    x1, y1 = road.max(0) + m
    lot = float(spec["lot"])
    boxes = []
    fp_lo, fp_hi = spec["footprint"]
    h_lo, h_hi = spec["height"]
    clear = float(spec["clear"])
    for cx in np.arange(x0 + 0.5 * lot, x1, lot):
        for cy in np.arange(y0 + 0.5 * lot, y1, lot):
            w, d = rng.uniform(fp_lo, fp_hi, 2)
            h = rng.uniform(h_lo, h_hi)
            jx, jy = rng.uniform(-0.5, 0.5, 2) * (lot - np.array([w, d]))
            keep = rng.uniform() < float(spec["building_p"])
            lo = np.array([cx + jx - 0.5 * w, cy + jy - 0.5 * d])
            hi = lo + np.array([w, d])
            gap = np.maximum(np.maximum(lo - road, road - hi), 0.0)
            if keep and np.linalg.norm(gap, axis=1).min() > clear:
                boxes.append([lo[0], lo[1], 0.0, hi[0], hi[1], h])
    seg = np.linalg.norm(np.diff(np.vstack([road, road[:1]]), axis=0),
                         axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])[:-1]
    every, off = float(spec["pole_every"]), float(spec["pole_offset"])
    half = 0.5 * float(spec["pole_width"])
    p_lo, p_hi = spec["pole_height"]
    tangent = np.gradient(road, axis=0)
    normal = np.stack([-tangent[:, 1], tangent[:, 0]], -1)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    for i in np.searchsorted(s, np.arange(0.0, s[-1], every)):
        for side in (-1.0, 1.0):
            c = road[i] + side * off * normal[i]
            boxes.append([c[0] - half, c[1] - half, 0.0, c[0] + half,
                          c[1] + half, rng.uniform(p_lo, p_hi)])
    return World(np.asarray(boxes), (x0, y0, x1, y1))


# ---- the sensors: each ray's direction in the LiDAR frame and its time ----

def livox_rosette(sensor: Dict, t0: float, dev, dt):
    """A Livox Avia's rays in the scan that starts at ``t0``: ``lasers``
    lasers firing together ``rate`` points a second in all, each steered by
    two prisms turning at ``prism_hz`` (opposite senses) over a circular
    field of ``fov_deg``, the lasers a sixth of a turn of the second prism
    apart; points in firing order, the lasers interleaved.  Returns (dirs
    (N, 3), time offsets (N,) in ns (int64), line (N,))."""
    L = int(sensor["lasers"])
    period = float(sensor["scan_period"])
    steps = int(round(float(sensor["rate"]) * period / L))
    # a step fires half a step after its turn, so no point's time is an IMU
    # sample's
    ns = ((torch.arange(steps, dtype=torch.int64) * 2 + 1)
          * int(round(0.5e9 * period / steps)))
    t = t0 + ns.to(dt).to(dev) * 1e-9
    w1, w2 = (2 * math.pi * float(f) for f in sensor["prism_hz"])
    amp = math.radians(0.25 * float(sensor["fov_deg"]))
    ph = torch.arange(L, dtype=dt, device=dev) * (2 * math.pi / L)
    u = amp * (torch.cos(w1 * t)[:, None] + torch.cos(w2 * t[:, None] + ph))
    v = amp * (torch.sin(w1 * t)[:, None] + torch.sin(w2 * t[:, None] + ph))
    d = torch.stack([torch.cos(v) * torch.cos(u), torch.cos(v) * torch.sin(u),
                     torch.sin(v)], -1).reshape(-1, 3)
    line = torch.arange(L, dtype=torch.uint8).repeat(steps)
    return d, ns.repeat_interleave(L), line


def spinning(sensor: Dict, t0: float, dev, dt):
    """An Ouster OS1's rays: ``rings`` beams from ``elev_max`` (row 0) down
    to ``elev_min``, ``columns`` a turn, turning clockwise; row-major like
    the driver's organised cloud; a column fires half a column after its
    share of the period.  Returns (dirs, time offsets in ns, ring)."""
    R, C = int(sensor["rings"]), int(sensor["columns"])
    period = float(sensor["scan_period"])
    el = torch.deg2rad(torch.linspace(float(sensor["elev_max"]),
                                      float(sensor["elev_min"]), R,
                                      dtype=dt, device=dev))
    az = -torch.arange(C, dtype=dt, device=dev) * (2 * math.pi / C)
    e, a = torch.meshgrid(el, az, indexing="ij")
    d = torch.stack([torch.cos(e) * torch.cos(a), torch.cos(e) * torch.sin(a),
                     torch.sin(e)], -1).reshape(-1, 3)
    ns = torch.round((torch.arange(C, dtype=torch.float64) + 0.5)
                     * (1e9 * period / C)).to(torch.int64)
    ring = torch.arange(R, dtype=torch.uint8).repeat_interleave(C)
    return d, ns.repeat(R), ring


SENSORS = {"livox_rosette": livox_rosette, "spinning": spinning}


@dataclasses.dataclass
class Lap:
    """The ramp's scans and one lap's, cast: scans ``0 .. ramp_scans - 1``
    are the ramp's, the next ``lap_scans`` the lap's, each of the sensor's
    ``N`` rays a scan (a miss has range 0).  The IMU is sampled from t = 0
    over the ramp and one lap."""

    kind: str
    period: float
    ramp_scans: int
    lap_scans: int
    dirs: np.ndarray  # (S, N, 3) f32 LiDAR-frame directions, or (1, N, 3)
    ranges: np.ndarray  # (S, N) f32 clean ranges, 0 for a miss
    ns: np.ndarray  # (N,) int64 time offsets from the scan's stamp
    line: np.ndarray  # (N,) uint8 laser or ring
    imu_dt: float
    imu_ramp: int  # samples before the lap
    imu_acc: np.ndarray  # (M, 3) clean specific force
    imu_gyr: np.ndarray  # (M, 3) clean rate

    @property
    def rays(self) -> int:
        return self.ranges.shape[1]

    def scan_index(self, s: int) -> int:
        """The lap's scan that replayed scan ``s`` is."""
        if s < self.ramp_scans:
            return s
        return self.ramp_scans + (s - self.ramp_scans) % self.lap_scans

    def imu_index(self, m: int) -> int:
        n = self.imu_acc.shape[0]
        if m < n:
            return m
        lap = n - self.imu_ramp
        return self.imu_ramp + (m - self.imu_ramp) % lap


def make_route(mix: Dict, period: float) -> Route:
    r = mix["route"]
    return Route(a=float(r["a"]), b=float(r["b"]), c=float(r["c"]),
                 lap_s=int(r["lap_scans"]) * period,
                 height=float(r["height"]), z_amp=float(r["z_amp"]),
                 z_harmonic=int(r["z_harmonic"]))


def make_lap(sensor: Dict, extrinsic_T, mix: Dict, device="cpu") -> Lap:
    """Cast the ramp and one lap of ``sensor`` (the configuration's sensor:
    ``pattern`` and its parameters, ``max_range``, ``scan_period``,
    ``imu_rate``), mounted at ``extrinsic_T`` in the body frame (its axes
    the body's), along the mix's ``route`` through its ``world``."""
    period = float(sensor["scan_period"])
    ramp, n_lap = int(mix["route"]["ramp_scans"]), int(
        mix["route"]["lap_scans"])
    route = make_route(mix, period)
    ramp_end = route.t_ramp_start + route.t_ramp
    if ramp_end + 0.01 > ramp * period:
        # the IMU's differences near the ramp's end are not the lap's
        raise ValueError(f"the ramp ends at {ramp_end} s, not before the "
                         f"{ramp} ramp scans end")
    world = make_world(route, mix["world"])
    dev = torch.device(device)
    f64 = torch.float64
    kind = sensor["pattern"]
    pattern = SENSORS[kind]
    lever = torch.as_tensor(np.asarray(extrinsic_T, np.float64), device=dev)
    max_range = float(sensor["max_range"])
    S = ramp + n_lap
    dirs, ranges = [], []
    ns = line = None
    for s in range(S):
        t0 = s * period
        d_l, ns, line = pattern(sensor, t0, dev, f64)
        T = t0 + ns.double().numpy() * 1e-9
        uniq, inv = np.unique(T, return_inverse=True)
        inv = torch.as_tensor(inv, device=dev)
        p = torch.as_tensor(route.pos(uniq), device=dev)[inv]
        yaw = torch.as_tensor(route.yaw(uniq), device=dev)[inv]
        c, sn = torch.cos(yaw), torch.sin(yaw)

        def rot(v):
            return torch.stack([c * v[..., 0] - sn * v[..., 1],
                                sn * v[..., 0] + c * v[..., 1], v[..., 2]],
                               -1)
        origin = p + rot(lever.expand_as(d_l))
        rng, hit = world.cast(origin, rot(d_l), max_range)
        ranges.append(torch.where(hit, rng, torch.zeros_like(rng)).float()
                      .cpu().numpy())
        if kind == "spinning":
            if s == 0:
                dirs.append(d_l.float().cpu().numpy())
        else:
            dirs.append(d_l.float().cpu().numpy())
    imu_dt = 1.0 / float(sensor["imu_rate"])
    m_ramp = int(round(ramp * period / imu_dt))
    m_all = int(round(S * period / imu_dt))
    f_b, w_b = route.imu(np.arange(m_all) * imu_dt)
    return Lap(kind=kind, period=period, ramp_scans=ramp, lap_scans=n_lap,
               dirs=np.stack(dirs), ranges=np.stack(ranges),
               ns=ns.numpy(), line=line.numpy(), imu_dt=imu_dt,
               imu_ramp=m_ramp, imu_acc=f_b, imu_gyr=w_b)


def seed_words(seed: int, lane: int = 0) -> List[int]:
    """The seed and lane as a numpy seed sequence's entropy (any integer
    seed, negative or past 64 bits, folded to unsigned 64-bit words)."""
    return [seed % (1 << 64), (seed >> 64) % (1 << 64), lane]


class Stream:
    """One sensor's replayed stream: scan ``s`` is the lap's scan
    ``lap.scan_index(s)`` at stamp ``s * period``, with noise drawn from
    ``seed``."""

    def __init__(self, lap: Lap, noise: Dict, seed: int):
        self.lap = lap
        self.rng = np.random.default_rng(seed_words(seed))
        self.range_noise = float(noise["range"])
        self.acc_noise = float(noise["acc"])
        self.gyr_noise = float(noise["gyr"])
        self.acc_bias = np.asarray(noise["acc_bias"], np.float64)
        self.gyr_bias = np.asarray(noise["gyr_bias"], np.float64)
        self.pool = self.rng.standard_normal(4 * lap.rays, dtype=np.float32)
        n = lap.rays
        # the fields a driver fills the same way every scan
        if lap.kind == "livox_rosette":
            self.fixed = dict(reflectivity=np.full(n, 100.0, np.float32),
                              offset_time_ns=lap.ns,
                              tag=np.full(n, 0x10, np.uint8), line=lap.line)
        else:
            self.fixed = dict(intensity=np.full(n, 100.0, np.float32),
                              t=lap.ns.astype(np.uint32), ring=lap.line)
        self.next_scan = 0
        self.next_imu = 0

    def imu_until(self, t_end: float):
        """The IMU samples up to ``t_end`` not yet given: (t (m,), acc (m,
        3), gyr (m, 3)), float32 values as a sensor gives them."""
        lap = self.lap
        m_end = int(math.floor(t_end / lap.imu_dt + 1e-6)) + 1
        ms = np.arange(self.next_imu, max(m_end, self.next_imu))
        self.next_imu = max(m_end, self.next_imu)
        idx = np.fromiter((lap.imu_index(int(m)) for m in ms), np.int64,
                          len(ms))
        noise = self.rng.standard_normal((len(ms), 6))
        acc = (lap.imu_acc[idx] + self.acc_bias
               + self.acc_noise * noise[:, :3]).astype(np.float32)
        gyr = (lap.imu_gyr[idx] + self.gyr_bias
               + self.gyr_noise * noise[:, 3:]).astype(np.float32)
        return ms * lap.imu_dt, acc, gyr

    def scan(self):
        """The next scan's driver message (a dict of arrays with its
        ``stamp``) and its lap index."""
        lap = self.lap
        s = self.next_scan
        self.next_scan += 1
        k = lap.scan_index(s)
        n = lap.rays
        o = int(self.rng.integers(0, self.pool.shape[0] - n + 1))
        r = lap.ranges[k]
        r = np.where(r > 0, r + self.range_noise * self.pool[o:o + n], 0.0)
        d = lap.dirs[k if lap.dirs.shape[0] > 1 else 0]
        xyz = (d * r[:, None].astype(np.float32)).astype(np.float32)
        return dict(self.fixed, stamp=s * lap.period, xyz=xyz), k

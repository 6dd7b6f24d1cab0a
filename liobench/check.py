"""The output check: the port's poses and covariances against the plain
reference (``reference/lio.py``), at the timed sizes, on what the timed path
produced.

A scan's result depends on all the scans before it, and the reference takes
seconds a scan where the window runs a hundred a second, so it follows the
program from the program's own state: a chain starts from a copy of the
program's state (its filter state, its map's points, the IMU carry, the
local-map cube) taken in the window before the first scan after a time
drawn from the seed, runs
that scan and the next ``steps - 1`` on its own state (its own map insert
between them), and each step's pose, state and covariance are held to what
the program reported and kept after the same scan.  The start is checked on
its own: the reference from nothing over the stream's first packets (the
IMU's static init, the scan that seeds the map, the ramp from rest and the
first seconds of driving, the map growing on both sides), against the
program's states after each.  The reference decodes each driver message
itself.

The numbers, each the largest over the start's steps (``start_...``) or
over the chains' steps (``chain_...``), two numbers since the start's
thirty scans from nothing drift further apart than a chain's three:

``pos_gap_m``    the position's distance from the reference's, of the pose
                 the program reported and of its state;
``rot_gap_rad``  the rotation between them, likewise;
``cov_gap``      the largest difference of the 23 x 23 covariance, over the
                 reference's largest entry.

A cell's limits file names the numbers it compares, each with its limit.

The control is the same comparison with the reference computed in float32
with TF32 matrix products in the program's place (``control``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch

from .reference import lio as ref
from .reference import sync

GAPS = ("pos_gap_m", "rot_gap_rad", "cov_gap")
NUMBERS = tuple(f"{part}_{k}" for part in ("start", "chain") for k in GAPS)


def map_points(packed: torch.Tensor) -> torch.Tensor:
    """The live points of a map's planar rows (H, 4B) [x | y | z | w] (w 0
    live), in row and slot order."""
    B = packed.shape[-1] // 4
    pts = torch.stack([packed[:, :B], packed[:, B:2 * B],
                       packed[:, 2 * B:3 * B]], -1).reshape(-1, 3)
    return pts[(packed[:, 3 * B:] == 0.0).reshape(-1)]


def _angle(q1: torch.Tensor, q2: torch.Tensor) -> float:
    d = ref.qmul(ref.qconj(q1), q2)
    return float(2.0 * torch.atan2(torch.linalg.norm(d[1:]), d[0].abs()))


def _gaps(post: Dict, pos, quat, P) -> Dict[str, float]:
    f64 = torch.float64
    dev = pos.device
    rep_pos, rep_quat = (v.to(dev, f64) for v in post["pose"])
    st_pos = post["x"]["pos"].to(dev, f64)
    st_quat = post["x"]["rot"].to(dev, f64)
    Pp = post["P"].to(dev, f64)
    return dict(
        pos_gap_m=max(float(torch.linalg.norm(rep_pos - pos)),
                      float(torch.linalg.norm(st_pos - pos))),
        rot_gap_rad=max(_angle(quat, rep_quat), _angle(quat, st_quat)),
        cov_gap=float((Pp - P).abs().max() / P.abs().max()))


def _merge(acc: Dict[str, float], g: Dict[str, float]):
    for k, v in g.items():
        v = v if math.isfinite(v) else math.inf
        acc[k] = max(acc.get(k, 0.0), v)


def _step(acc: Dict, tally: Dict, post: Dict, lio) -> None:
    """Merge one compared step's gaps, and tally whether the program's
    filter made as many passes as the reference's (where the post says),
    with the largest position gap either way."""
    g = _gaps(post, lio.x["pos"].double(), lio.x["rot"].double(),
              lio.P.double())
    _merge(acc, g)
    if post.get("passes") is not None:
        same = int(post["passes"]) == lio.passes
        key = "same_passes" if same else "other_passes"
        tally[key] = tally.get(key, 0) + 1
        gap = key + "_pos_gap_m"
        tally[gap] = max(tally.get(gap, 0.0), g["pos_gap_m"])


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 matrix products on CUDA while the control runs."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _imu(records):
    return (np.concatenate([r[1] for r in records]),
            np.concatenate([r[2] for r in records]),
            np.concatenate([r[3] for r in records]))


def _scans(cfg: Dict, records):
    """Each record's message as the reference's preprocessing keeps it:
    (stamp, points, times)."""
    return [(float(r[0]["stamp"]), *sync.decode(r[0], cfg)) for r in records]


def run_start(cfg: Dict, start: Dict, dtype, device, acc: Dict,
              tally: Dict) -> int:
    """The reference from nothing over the first packets."""
    recs = start["records"]
    if not recs:
        return 0
    lio = ref.RefLIO(cfg, dtype, device)
    n = 0
    for pkt, post in zip(sync.packets(_scans(cfg, recs), *_imu(recs)),
                         start["posts"]):
        out = lio.process_packet(pkt)
        if post is None or out is None:
            continue
        _step(acc, tally, post, lio)
        n += 1
    return n


def run_chain(cfg: Dict, chain: Dict, dtype, device, acc: Dict,
              tally: Dict) -> int:
    """The reference over one chain from the program's state before it."""
    pre = chain["pre"]
    lio = ref.RefLIO(cfg, dtype, device)
    lio.load(pre["x"], pre["P"], map_points(pre["packed"]),
             pre["angvel_last"].tolist(), pre["acc_s_last"].tolist(),
             pre["lm_lo"].tolist(), pre["lm_hi"].tolist(),
             bool(pre["lm_init"]), pre["acc_scale"],
             pre["first_lidar_time"], pre["last_end"], pre["map_built"])
    prev = _scans(cfg, [chain["prev"]])[0]
    recs = [chain["prev"]] + chain["records"]
    pkts = sync.packets(_scans(cfg, chain["records"]), *_imu(recs),
                        prev_end=prev[0] + float(prev[2][-1]))
    n = 0
    for pkt, post in zip(pkts, chain["posts"]):
        lio.process_packet(pkt)
        _step(acc, tally, post, lio)
        n += 1
    return n


def compare(cfg: Dict, driver, device, control: bool = False) -> Dict:
    """The check's numbers over the driver's start and chains: the
    reference in float64, or (``control``) in float32 with TF32 products.
    Returns the numbers, those of the start and the chains apart, how many
    steps each compared, and the tally of the filter's passes."""
    dtype = torch.float32 if control else torch.float64
    start: Dict[str, float] = {}
    chain: Dict[str, float] = {}
    tally: Dict[str, float] = {}
    with precision(control), torch.no_grad():
        n_start = run_start(cfg, driver.start, dtype, device, start, tally)
        n_chain = sum(run_chain(cfg, c, dtype, device, chain, tally)
                      for c in driver.chains if c["posts"])
    numbers = {f"{name}_{k}": part.get(k, math.inf)
               for name, part in (("start", start), ("chain", chain))
               for k in GAPS}
    return dict(numbers=numbers,
                start=start, chain=chain, passes=tally, start_steps=n_start,
                chain_steps=n_chain,
                chains=sum(1 for c in driver.chains if c["posts"]))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the limits name within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)


def lines(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> List[str]:
    return [f"check {k} {numbers[k]!r} limit {limits[k]!r}" for k in limits]

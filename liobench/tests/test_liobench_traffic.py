"""The lap generator's laps join smoothly, its campus keeps the road clear,
its sensors' messages decode as their drivers' do, and its noise follows
the seed; the rooflines' work against hand counts."""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from liobench import roofline, traffic
from liobench.reference import sync
from liobench.tests.tiny import ROUTE, WORLD

ROOT = Path(__file__).resolve().parents[2]
MIX = json.loads((ROOT / "liobench/mixes/replay.json").read_text())
MIX["route"].update(ROUTE)
MIX["world"].update(WORLD)
CONFIGS = {n: json.loads((ROOT / f"liobench/configs/{n}.json").read_text())
           for n in ("avia", "ouster64")}
SMALL = {"avia": {"rate": 12000}, "ouster64": {"rings": 16, "columns": 128}}
NOISE = CONFIGS["avia"]["assumed"]["noise"]


def _sensor(name):
    return dict(CONFIGS[name]["assumed"]["sensor"], **SMALL[name])


@pytest.fixture(scope="module", params=("avia", "ouster64"))
def lap(request):
    torch.set_num_threads(2)
    conf = CONFIGS[request.param]
    return request.param, traffic.make_lap(
        _sensor(request.param), conf["config"]["extrinsic_T"], MIX)


def _feed(stream, n):
    """n scans: (message, [(t, acc, gyr), ...]) each."""
    rows = []
    for _ in range(n):
        msg, _k = stream.scan()
        t, acc, gyr = stream.imu_until(msg["stamp"] + stream.lap.period)
        rows.append((msg, list(zip(t, acc, gyr))))
    return rows


def test_route_is_periodic_after_the_ramp():
    tr = traffic.make_route(MIX, 0.1)
    T = tr.lap_s
    t = np.linspace(2.5, 2.5 + T, 50)
    np.testing.assert_allclose(tr.pos(t + T), tr.pos(t), atol=1e-9)
    np.testing.assert_allclose(np.cos(tr.yaw(t + T)), np.cos(tr.yaw(t)),
                               atol=1e-12)
    assert tr.yaw(t[0] + T) == pytest.approx(tr.yaw(t[0]) + 2 * math.pi)
    f0, w0 = tr.imu(t)
    f1, w1 = tr.imu(t + T)
    np.testing.assert_allclose(f1, f0, atol=1e-6)
    np.testing.assert_allclose(w1, w0, atol=1e-6)
    # at rest before the ramp: gravity alone, no turn
    f, w = tr.imu(np.array([0.1, 0.3]))
    np.testing.assert_allclose(f, [[0, 0, traffic.G]] * 2, atol=1e-6)
    np.testing.assert_allclose(w, 0.0, atol=1e-9)


def test_campus_keeps_the_road_clear():
    """No building stands within ``clear`` of the road; a pole stands by
    the kerb, off the road; the layout is the world seed's alone."""
    full = json.loads((ROOT / "liobench/mixes/replay.json").read_text())
    route = traffic.make_route(full, 0.1)
    world = traffic.make_world(route, full["world"])
    again = traffic.make_world(route, full["world"])
    np.testing.assert_array_equal(world.boxes, again.boxes)
    road = route.xy(np.linspace(0, 2 * math.pi, 8192, endpoint=False))
    off = full["world"]["pole_offset"]
    x0, y0, x1, y1 = world.extent
    assert x1 - x0 >= 200 and y1 - y0 >= 200  # a few hundred metres
    width = world.boxes[:, 3] - world.boxes[:, 0]
    poles = width < 1.0
    assert poles.sum() > 20 and (~poles).sum() > 10
    for lo_x, lo_y, _z, hi_x, hi_y, _h in world.boxes:
        gap = np.maximum(np.maximum(np.array([lo_x, lo_y]) - road,
                                    road - np.array([hi_x, hi_y])), 0.0)
        d = np.linalg.norm(gap, axis=1).min()
        if hi_x - lo_x < 1.0:  # a pole: by the kerb, off the road
            assert 0.5 * off < d <= off
        else:
            assert d > full["world"]["clear"]


def test_messages_decode_as_their_drivers(lap):
    """Each message has the driver's fields and every ray; decoded, its
    last point is its latest, the sync's scan end; a ray cast in an open
    direction misses."""
    name, lp = lap
    conf = CONFIGS[name]
    msg = _feed(traffic.Stream(lp, NOISE, 3), 1)[0][0]
    assert msg["xyz"].shape == (lp.rays, 3) and msg["xyz"].dtype == np.float32
    missed = ~np.any(msg["xyz"] != 0, axis=1)
    assert 0 < missed.sum() < lp.rays
    pts, t = sync.decode(msg, conf["config"])
    assert len(pts) > 50 and t[-1] == t.max() < lp.period
    assert np.all((pts.astype(np.float64) ** 2).sum(1)
                  > conf["config"]["blind"] ** 2 - 1e-3)
    if name == "avia":
        assert set(np.unique(msg["line"])) == set(range(6))
        assert msg["offset_time_ns"].dtype == np.int64
    else:
        cols = SMALL[name]["columns"]
        kept = np.flatnonzero(np.arange(lp.rays) % 4 == 0)
        assert np.all(kept % cols % 4 == 0)
        # the bottom beam sees the ground all round
        assert not missed[-cols:].any()


def test_laps_join_smoothly(lap):
    """Across the lap's end the replayed stream's stamps keep increasing and
    its IMU continues the closed form; a scan of the second lap is the
    first lap's, point for point, where the noise is off."""
    name, lp = lap
    tr = traffic.make_route(MIX, lp.period)
    end = lp.ramp_scans + lp.lap_scans
    assert [lp.scan_index(s) for s in (end - 1, end, end + 1)] == [
        end - 1, lp.ramp_scans, lp.ramp_scans + 1]
    m_end = lp.imu_acc.shape[0]
    for m in range(m_end - 3, m_end + 3):
        f, w = tr.imu(m * lp.imu_dt)
        np.testing.assert_allclose(lp.imu_acc[lp.imu_index(m)], f,
                                   atol=1e-6)
        np.testing.assert_allclose(lp.imu_gyr[lp.imu_index(m)], w,
                                   atol=1e-6)
    quiet = dict(NOISE, range=0.0, acc=0.0, gyr=0.0)
    rows = _feed(traffic.Stream(lp, quiet, 1), end + 3)
    stamps = [r[0]["stamp"] for r in rows]
    assert np.all(np.diff(stamps) > 0)
    imu_t = np.concatenate([[t for t, _a, _g in r[1]] for r in rows])
    np.testing.assert_allclose(np.diff(imu_t), lp.imu_dt, atol=1e-9)
    first, again = rows[lp.ramp_scans][0], rows[end][0]
    np.testing.assert_array_equal(first["xyz"], again["xyz"])
    assert again["stamp"] == pytest.approx(first["stamp"] + tr.lap_s)


def test_noise_follows_the_seed(lap):
    _name, lp = lap
    a = _feed(traffic.Stream(lp, NOISE, 7), 3)
    b = _feed(traffic.Stream(lp, NOISE, 7), 3)
    c = _feed(traffic.Stream(lp, NOISE, 8), 3)
    big = _feed(traffic.Stream(lp, NOISE, 2**31 + 12345), 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[0]["xyz"], y[0]["xyz"])
        np.testing.assert_array_equal(np.stack([i[1] for i in x[1]]),
                                      np.stack([i[1] for i in y[1]]))
    for other in (c, big):
        assert not np.array_equal(a[2][0]["xyz"], other[2][0]["xyz"])
        assert not np.array_equal(np.stack([i[1] for i in a[2][1]]),
                                  np.stack([i[1] for i in other[2][1]]))
    # the noise is the stated size: range noise of 2 cm along each ray
    quiet = _feed(traffic.Stream(lp, dict(NOISE, range=0.0), 7), 3)
    hit = np.any(quiet[2][0]["xyz"] != 0, axis=1)
    d = (np.linalg.norm(a[2][0]["xyz"][hit], axis=1)
         - np.linalg.norm(quiet[2][0]["xyz"][hit], axis=1))
    assert 0.015 < d.std() < 0.025


def test_segment_mean_work_by_hand():
    """Six points in three voxels of 1 m (3, 2, 1 points), two kept."""
    pts = torch.tensor([[0.1, 0.1, 0.1], [0.2, 0.1, 0.1], [0.3, 0.1, 0.1],
                        [1.5, 0.1, 0.1], [1.6, 0.1, 0.1], [2.5, 0.1, 0.1]])
    w = roofline.segment_mean_work(pts, 1.0, n_out=2, cols=4)
    kept = 5  # the voxels of 3 and 2 points
    assert w.nbytes == kept * (4 * 4 + 1) + (2 + 1) * 8 + 2 * (4 * 4 + 1)
    assert w.ops == kept * 9 + 2 * 4
    assert w.chain_s == pytest.approx(3 * 4 / 1.98e9)
    assert w.seconds() == pytest.approx(max(w.nbytes / 3.35e12,
                                            w.ops / 67e12, w.chain_s))


def test_knn_work_by_hand():
    """One query at the centre of a 2 m cell of an empty-but-one map: its
    2x2x2 region's eight distinct rows read once, 15 operations for each of
    its live slots and one for each free slot."""
    H_log2, B, cell = 4, 8, 2.0
    packed = torch.zeros((1 << H_log2, 4 * B))
    packed[:, 3 * B:] = 1e18
    q = torch.tensor([[1.2, 1.2, 1.2]])
    base = torch.floor(q / cell - 0.5).long()
    r = torch.arange(2)
    cells = base[:, None] + torch.stack(
        torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    buckets = roofline.bucket_of(cells, H_log2)[0]
    packed[buckets[0], 3 * B] = 0.0  # one live slot in the first row
    distinct = torch.unique(buckets)
    w = roofline.knn_work(packed, q, cell, H_log2, wide=False)
    per_query = (3 + 5 * 4) * 4 + 5
    assert w.nbytes == distinct.numel() * 4 * B * 4 + per_query
    live = 1
    assert w.ops == 15 * live + (distinct.numel() * B - live)


def test_bucket_hash_matches_the_maps_layout():
    """The yardstick's copy of the spatial hash gives the port's buckets."""
    from fast_lio_tpu_torch.map import hash_map as hm
    cells = torch.randint(-500, 500, (1000, 3), dtype=torch.int32)
    for h in (12, 15):
        assert torch.equal(roofline.bucket_of(cells, h),
                           hm._bucket_of(cells, h))

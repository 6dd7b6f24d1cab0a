"""Packet synchronization (sync_packages, laserMapping.cpp:368-424) in both
packages: the five cases of tests/test_sync.py run through the JAX
package's ``SyncBuffer`` and the port's, every popped packet compared field
by field and tests/test_sync.py's own assertions held on the port's; then a
pipeline run with the soft time sync on (the IMU's clock 5 s behind the
LiDAR's) and a clock offset between them, port against JAX.

Tolerances: the buffers are the same host code, so packets and state are
equal; the pipeline runs are held to tests/test_torch_pipeline.py's
bounds, 5 mm per scan in float32 and 1e-6 m in float64.
"""
import dataclasses

import numpy as np
import pytest

from fast_lio_tpu import sim as simlib
from fast_lio_tpu.config import Config as JConfig
from fast_lio_tpu.config import LidarType as JLidarType
from fast_lio_tpu.pipeline import Pipeline as JPipeline
from fast_lio_tpu.pipeline import SyncBuffer as JSyncBuffer
from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import pipeline as tpipe
from test_torch_pipeline import POS_TOL, SMALL, _positions
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIDES = {"jax": (JConfig, JSyncBuffer), "port": (tcfg.Config,
                                                 tpipe.SyncBuffer)}
GRAVITY = [0, 0, 9.8]
STILL = [0, 0, 0]


def mk(n=100, t0=10.0):
    pts = np.random.default_rng(0).uniform(1, 5, (n, 3)).astype(np.float32)
    ptt = np.linspace(0, 0.1, n)
    return t0, pts, ptt


def waits_for_imu(sb, out):
    t0, pts, ptt = mk()
    sb.push_lidar(t0, pts, ptt)
    sb.push_imu(t0 + 0.05, GRAVITY, STILL)
    out.append(sb.pop_packet())  # IMU hasn't reached scan end yet
    sb.push_imu(t0 + 0.11, GRAVITY, STILL)
    out.append(sb.pop_packet())


def previous_tail_sample_prepended(sb, out):
    t0, pts, ptt = mk()
    for i in range(25):
        sb.push_imu(t0 - 0.05 + i * 0.01, GRAVITY, STILL)
    sb.push_lidar(t0, pts, ptt)
    out.append(sb.pop_packet())
    sb.push_lidar(t0 + 0.1, pts, ptt)
    for i in range(25):
        sb.push_imu(t0 + 0.2 + i * 0.01, GRAVITY, STILL)
    out.append(sb.pop_packet())


def mean_scantime_fallback(sb, out):
    t0, pts, ptt = mk()
    sb.push_imu(t0 + 0.2, GRAVITY, STILL)
    sb.push_lidar(t0, pts, ptt)
    out.append(sb.pop_packet())
    # degenerate scan (1 point): end time falls back to mean scantime
    sb.push_lidar(t0 + 0.1, pts[:1], ptt[:1])
    sb.push_imu(t0 + 0.3, GRAVITY, STILL)
    out.append(sb.pop_packet())


def loopback_clears_buffers(sb, out):
    t0, pts, ptt = mk()
    sb.push_lidar(t0, pts, ptt)
    sb.push_lidar(t0 - 5.0, pts, ptt)  # time jumped backwards
    sb.push_imu(t0, GRAVITY, STILL)
    sb.push_imu(t0 - 5.0, GRAVITY, STILL)
    out.append(sb.pop_packet())


def soft_time_sync(sb, out):
    # IMU clock runs 5 s behind the LiDAR clock
    for i in range(5):
        sb.push_imu(5.0 + i * 0.01, GRAVITY, STILL)
    sb.push_lidar(10.0, *mk()[1:])
    sb.push_imu(5.05, GRAVITY, STILL)
    out.append(sb.pop_packet())


CASES = {f.__name__: (f, cfg) for f, cfg in (
    (waits_for_imu, {}), (previous_tail_sample_prepended, {}),
    (mean_scantime_fallback, {}), (loopback_clears_buffers, {}),
    (soft_time_sync, {"time_sync_en": True}))}
STATE = ("imu_t", "mean_scantime", "scan_num", "last_timestamp_lidar",
         "last_timestamp_imu", "timediff_lidar_wrt_imu", "timediff_set")


def run_case(side, name):
    """The case's buffer after it ran, and the packets it popped."""
    Config, SyncBuffer = SIDES[side]
    fn, kw = CASES[name]
    sb, out = SyncBuffer(Config(**kw)), []
    fn(sb, out)
    return sb, out


def _same_packet(p, q):
    assert (p is None) == (q is None)
    if p is None:
        return
    a, b = dataclasses.asdict(p), dataclasses.asdict(q)
    assert list(a) == list(b)
    for field in a:
        if isinstance(a[field], np.ndarray):
            assert a[field].dtype == b[field].dtype, field
            np.testing.assert_array_equal(a[field], b[field], err_msg=field)
        else:
            assert a[field] == b[field], field


@pytest.mark.parametrize("name", list(CASES))
def test_sync_case_matches_jax(name):
    (jsb, jout), (tsb, tout) = run_case("jax", name), run_case("port", name)
    assert len(tout) == len(jout)
    for p, q in zip(tout, jout):
        _same_packet(p, q)
    for attr in STATE:
        assert getattr(tsb, attr) == getattr(jsb, attr), attr
    assert len(tsb.lidar_buf) == len(jsb.lidar_buf)
    # tests/test_sync.py's assertions, on the port's run
    if name == "waits_for_imu":
        assert tout[0] is None and tout[1] is not None
        np.testing.assert_allclose(tout[1].lidar_end_time, 10.0 + 0.1)
        assert (tout[1].imu_t <= tout[1].lidar_end_time + 1e-12).all()
    elif name == "previous_tail_sample_prepended":
        assert tout[1].imu_t[0] == tout[0].imu_t[-1]
    elif name == "mean_scantime_fallback":
        np.testing.assert_allclose(tout[1].lidar_end_time, 10.0 + 0.1 + 0.1)
    elif name == "loopback_clears_buffers":
        assert len(tsb.lidar_buf) == 1 and len(tsb.imu_t) == 1
    else:
        assert tsb.timediff_set
        np.testing.assert_allclose(tsb.timediff_lidar_wrt_imu,
                                   10.0 + 0.1 - 5.04)
        assert abs(tsb.imu_t[-1] - (5.05 + tsb.timediff_lidar_wrt_imu)) < 1e-9


IMU_BEHIND_S = 5.0  # the IMU's clock behind the LiDAR's
OFFSET_S = 0.002  # time_offset_lidar_to_imu


def _feed_offset_clocks(pipe, data):
    """Each scan with the IMU samples up to 0.1 s after its stamp, the
    samples stamped on a clock IMU_BEHIND_S behind and OFFSET_S ahead of
    the LiDAR's."""
    imu_i = 0
    for k in range(len(data.scans)):
        stamp = data.scan_stamps[k]
        while (imu_i < len(data.imu_t)
               and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9):
            pipe.push_imu(data.imu_t[imu_i] - IMU_BEHIND_S + OFFSET_S,
                          data.imu_acc[imu_i], data.imu_gyr[imu_i])
            imu_i += 1
        pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while pipe.spin_once():
            pass


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_time_synced_pipeline_matches_jax(dtype):
    kw = dict(det_range=450.0, compute_dtype=dtype, time_sync_en=True,
              time_offset_lidar_to_imu=OFFSET_S, **SMALL)
    data = simlib.generate(simlib.SimConfig(duration=1.6, n_rings=8,
                                            n_azimuth=200, range_noise=0.01))
    pj = JPipeline(JConfig(lidar_type=JLidarType.AVIA, **kw))
    pt = tpipe.Pipeline(tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **kw),
                        device="cpu")
    _feed_offset_clocks(pj, data)
    _feed_offset_clocks(pt, data)
    assert pt.sync.timediff_set and pj.sync.timediff_set
    assert pt.sync.timediff_lidar_wrt_imu == pj.sync.timediff_lidar_wrt_imu
    assert abs(pt.sync.timediff_lidar_wrt_imu - IMU_BEHIND_S) < 0.02
    pos_t, pos_j = _positions(pt), _positions(pj)
    assert len(pos_t) == len(pos_j) >= 12
    assert [t for t, _, _ in pt.get_trajectory()] == [
        t for t, _, _ in pj.get_trajectory()]
    np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=POS_TOL[dtype])
    assert simlib.ate_rmse(pt.get_trajectory(), data) < 0.05

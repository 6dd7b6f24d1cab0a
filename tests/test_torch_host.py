"""The port's host modules against the JAX package's: ROS1 bags written by
one package and read by the other, the LiDAR decoders (native library and
numpy), the feature extraction, and the timing CSV and pos log writers.

These are numpy code in both packages, so every comparison is exact: equal
bytes, equal arrays.
"""
import numpy as np
import pytest

from fast_lio_tpu import native as jnative
from fast_lio_tpu.config import Config as JConfig
from fast_lio_tpu.config import LidarType as JLidarType
from fast_lio_tpu.config import TimeUnit as JTimeUnit
from fast_lio_tpu.io import rosbag as jrb
from fast_lio_tpu.preprocess import drivers as jdrv
from fast_lio_tpu.preprocess import features as jfeat
from fast_lio_tpu.utils import timing as jtiming
from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import native as tnative
from fast_lio_tpu_torch.io import rosbag as trb
from fast_lio_tpu_torch.preprocess import drivers as tdrv
from fast_lio_tpu_torch.preprocess import features as tfeat
from fast_lio_tpu_torch.utils import timing as ttiming
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _configs(lidar: str, **kw):
    j = JConfig(lidar_type=getattr(JLidarType, lidar), **{
        k: getattr(JTimeUnit, v) if k == "time_unit" else v
        for k, v in kw.items()})
    t = tcfg.Config(lidar_type=getattr(tcfg.LidarType, lidar), **{
        k: getattr(tcfg.TimeUnit, v) if k == "time_unit" else v
        for k, v in kw.items()})
    return j, t


def _messages(rng):
    """One message of each type FAST-LIO consumes, serialised: (topic,
    type, stamp, bytes) from the given serialiser module."""
    n = 300
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    pc = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
          "intensity": rng.uniform(0, 100, n).astype(np.float32),
          "time": np.linspace(0, 99, n).astype(np.float32),
          "ring": (np.arange(n) % 16).astype(np.uint16)}

    def make(rb):
        return {
            "imu": ("/imu", "sensor_msgs/Imu", 100.01, rb.serialize_imu(
                100.01, [0.1, -0.2, 9.8], [0.01, 0.02, -0.03])),
            "livox": ("/livox/lidar", "livox_ros_driver/CustomMsg", 100.02,
                      rb.serialize_livox(
                          100.02, xyz, np.arange(n) % 255,
                          (np.arange(n) * 1000).astype(np.int64),
                          np.full(n, 0x10, np.uint8),
                          (np.arange(n) % 6).astype(np.uint8))),
            "livox2": ("/livox/lidar2", "livox_ros_driver2/CustomMsg",
                       100.03, rb.serialize_livox(
                           100.03, xyz, np.arange(n) % 7,
                           (np.arange(n) * 10).astype(np.int64),
                           np.full(n, 0x00, np.uint8),
                           (np.arange(n) % 4).astype(np.uint8))),
            "pointcloud2": ("/points", "sensor_msgs/PointCloud2", 100.05,
                            rb.serialize_pointcloud2(100.05, pc)),
        }
    return make


def _write(rb, path, records):
    w = rb.BagWriter(path)
    for rec in records:
        w.write(*rec)
    w.close()


def _read_all(rb, path):
    reader = rb.BagReader(path)
    try:
        return list(reader.messages())
    finally:
        reader.close()


def _assert_msgs_equal(a, b):
    assert len(a) == len(b)
    for (ta, ma, sa, da), (tb, mb, sb, db) in zip(a, b):
        assert (ta, ma, sa) == (tb, mb, sb)
        assert set(da) == set(db)
        for k in da:
            np.testing.assert_array_equal(np.asarray(da[k]), np.asarray(db[k]))
            assert np.asarray(da[k]).dtype == np.asarray(db[k]).dtype


@pytest.mark.parametrize("kind", ["imu", "livox", "livox2", "pointcloud2"])
def test_bag_written_by_one_package_reads_in_the_other(kind, tmp_path):
    rng = np.random.default_rng(81)
    make = _messages(rng)
    rec_t, rec_j = make(trb)[kind], make(jrb)[kind]
    assert rec_t[3] == rec_j[3]  # the serialisers give the same bytes
    _write(trb, tmp_path / "port.bag", [rec_t, rec_t])
    _write(jrb, tmp_path / "jax.bag", [rec_j, rec_j])
    assert ((tmp_path / "port.bag").read_bytes()
            == (tmp_path / "jax.bag").read_bytes())
    port_by_jax = _read_all(jrb, tmp_path / "port.bag")
    jax_by_port = _read_all(trb, tmp_path / "jax.bag")
    assert len(port_by_jax) == 2
    _assert_msgs_equal(port_by_jax, jax_by_port)
    _assert_msgs_equal(_read_all(trb, tmp_path / "port.bag"), port_by_jax)


def test_bag_errors_are_named(tmp_path):
    bad = tmp_path / "bad.bag"
    bad.write_bytes(b"not a bag at all")
    with pytest.raises(trb.BagFormatError, match="ROS1"):
        trb.BagReader(bad)
    empty = tmp_path / "empty.bag"
    empty.write_bytes(b"")
    with pytest.raises(trb.BagFormatError, match="empty"):
        trb.BagReader(empty)


def _decoder_case(lidar, rng):
    """(config kwargs, message) for one sensor path."""
    n = 4000
    xyz = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    xyz[100] = xyz[99]  # a duplicate return
    inten = rng.uniform(0, 100, n).astype(np.float32)
    if lidar == "AVIA":
        return dict(n_scans=6, blind=2.0, point_filter_num=3), dict(
            xyz=xyz, reflectivity=inten,
            offset_time_ns=(np.arange(n) * 1e4).astype(np.int64),
            tag=rng.choice([0x00, 0x10, 0x20, 0x30], n).astype(np.uint8),
            line=rng.integers(0, 8, n).astype(np.uint8))
    if lidar == "OUST64":
        return dict(blind=1.5, point_filter_num=2, time_unit="NS"), dict(
            xyz=xyz, intensity=inten, t=(np.arange(n) * 1e5).astype(np.int64))
    if lidar == "VELO16":  # no per-point time: azimuth reconstruction
        return dict(blind=1.0, point_filter_num=2, scan_rate=10), dict(
            xyz=xyz, intensity=inten, time=np.zeros(n, np.float32),
            ring=(np.arange(n) % 16).astype(np.uint16))
    if lidar == "VELO16_TIMED":
        return dict(blind=1.0, point_filter_num=1, time_unit="MS"), dict(
            xyz=xyz, intensity=inten,
            time=np.linspace(0.0, 99.0, n).astype(np.float32),
            ring=(np.arange(n) % 16).astype(np.uint16))
    return dict(blind=0.5), dict(xyz=xyz, intensity=inten)  # MARSIM


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("lidar", ["AVIA", "OUST64", "VELO16",
                                   "VELO16_TIMED", "MARSIM"])
def test_decode_matches_jax(lidar, use_native):
    rng = np.random.default_rng(82)
    kw, msg = _decoder_case(lidar, rng)
    jc, tc = _configs(lidar.replace("_TIMED", ""), **kw)
    assert tnative.available() == jnative.available()
    got = tdrv.decode(msg, tc, use_native=use_native)
    want = jdrv.decode(msg, jc, use_native=use_native)
    assert len(got.pts) > 100
    for a, b in ((got.pts, want.pts), (got.time_offset_s, want.time_offset_s),
                 (got.intensity, want.intensity)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _ring_on_walls(n, r1=10.0):
    """One ring sweeping two walls and a corner (tests/test_features.py)."""
    ang = np.linspace(-0.9 * np.pi, 0.9 * np.pi, n)
    d = np.where(np.abs(ang) < np.pi / 4, r1 / np.cos(ang),
                 r1 / np.abs(np.sin(ang)) * 0.8)
    return np.stack([d * np.cos(ang), d * np.sin(ang),
                     np.zeros(n)], -1).astype(np.float64)


@pytest.mark.parametrize("lidar", ["AVIA", "VELO16"])
def test_extract_surfaces_matches_jax(lidar):
    ring = _ring_on_walls(300)
    n = 2 * len(ring)
    xyz = np.concatenate([ring, ring + [0, 0, 0.3]])
    if lidar == "AVIA":
        kw = dict(n_scans=2, blind=0.5, point_filter_num=2,
                  feature_extract_enable=True)
        msg = dict(xyz=xyz, line=np.repeat([0, 1], len(ring)).astype(np.uint8),
                   tag=np.full(n, 0x10, np.uint8),
                   reflectivity=np.ones(n, np.float32),
                   offset_time_ns=np.tile(np.linspace(0, 1e8, len(ring)),
                                          2).astype(np.int64))
    else:
        kw = dict(n_scans=2, blind=0.5, point_filter_num=1,
                  feature_extract_enable=True, time_unit="MS")
        msg = dict(xyz=xyz, ring=np.repeat([0, 1], len(ring)).astype(np.uint16),
                   intensity=np.linspace(0, 50, n).astype(np.float32),
                   time=np.tile(np.linspace(0, 99, len(ring)), 2))
    jc, tc = _configs(lidar, **kw)
    got = tfeat.extract_surfaces(msg, None, tc)
    want = jfeat.extract_surfaces(msg, None, jc)
    assert len(got.pts) > 50
    np.testing.assert_array_equal(got.pts, want.pts)
    np.testing.assert_array_equal(got.time_offset_s, want.time_offset_s)
    np.testing.assert_array_equal(got.intensity, want.intensity)
    via_decode = tdrv.decode(msg, tc, use_native=False)
    np.testing.assert_array_equal(via_decode.pts, got.pts)


def test_timing_csv_and_pos_log_are_byte_identical(tmp_path):
    rng = np.random.default_rng(83)
    rows = [dict(time_stamp=100.0 + 0.1 * i, total_time=rng.uniform(0, 0.1),
                 scan_point_size=int(rng.integers(1000, 20000)),
                 incremental_time=1e-4, search_time=2.5e-4,
                 delete_time=3e-5, tree_size_end=int(1000 * i),
                 add_point_size=int(rng.integers(100, 8000)),
                 preprocess_time=rng.uniform(0, 1e-2), n_eff=i * 7)
            for i in range(6)]
    # t, rot_log, pos, vel, bg, ba, grav per line, f32 as the CLI passes them
    states = [(0.1 * i, *rng.normal(size=(6, 3)).astype(np.float32))
              for i in range(4)]
    assert ttiming.CSV_HEADER == jtiming.CSV_HEADER
    for mod, name in ((ttiming, "port"), (jtiming, "jax")):
        log = mod.TimingLog()
        for r in rows:
            log.append(mod.ScanTiming(**r))
        log.write_csv(tmp_path / f"{name}.csv")
        slog = mod.StateLog(tmp_path / f"{name}_pos.txt")
        for s in states:
            slog.append(*s)
        slog.close()
        assert log.summary()["frames"] == 6
    for suffix in (".csv", "_pos.txt"):
        assert ((tmp_path / f"port{suffix}").read_bytes()
                == (tmp_path / f"jax{suffix}").read_bytes())

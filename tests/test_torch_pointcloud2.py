"""``sensor_msgs/PointCloud2`` bags of the sim (the port's
``sim.write_pointcloud2_bag``): Velodyne with its time field and without it
(the decoder's azimuth reconstruction), Ouster and MARSIM, read and decoded
by both packages, and replayed by both packages' runners on the CPU.

Tolerances: reading and decoding are exact (the same numpy code in both
packages, and the same native library), so every point, offset and
intensity is bit-equal to the JAX package's, for the numpy decoders and the
native ones; the runners' f32 pipelines agree to 5 mm a scan (ROADMAP.md
section C), over the same scans.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

from fast_lio_tpu import cli as jcli
from fast_lio_tpu import config as jconfig
from fast_lio_tpu import native as jnative
from fast_lio_tpu.io import rosbag as jrosbag
from fast_lio_tpu.preprocess import drivers as jdrivers
from fast_lio_tpu_torch import cli as tcli
from fast_lio_tpu_torch import config as tconfig
from fast_lio_tpu_torch import native as tnative
from fast_lio_tpu_torch import sim as tsim
from fast_lio_tpu_torch.io import rosbag as trosbag
from fast_lio_tpu_torch.preprocess import drivers as tdrivers
from fast_lio_tpu_torch.tools import scenarios
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

POS_TOL_M = 5e-3
# each kind's preset, its sim shape at a few hundred points a scan
PRESET_OF = {"velodyne": "velodyne", "velodyne_no_time": "velodyne",
             "ouster": "ouster64", "marsim": "marsim"}
SMALL_SIMS = {
    "velodyne": dict(n_rings=16, n_azimuth=60, elev_min=-15.0, elev_max=15.0,
                     spin=-1),
    "ouster64": dict(n_rings=32, n_azimuth=48, elev_min=-22.5,
                     elev_max=22.5),
    "marsim": dict(n_rings=12, n_azimuth=60, max_range=30.0),
}
# the presets cut to a small run's pads and map
SMALL = dict(n_points_max=1024, n_ds_max=512, n_imu_max=32, map_h_log2=11)


def _sim(preset, duration, **kw):
    sim_cfg = tsim.SimConfig(duration=duration, range_noise=0.005,
                             **SMALL_SIMS[preset], **kw)
    return sim_cfg, tsim.generate(sim_cfg)


def test_fields_carry_time_and_ring():
    """The ring field is the elevation band (in the sim's azimuth-major
    order: the point's index modulo the rings, every ray a hit); Velodyne's
    time is ms, Ouster's t ns."""
    sim_cfg, data = _sim("velodyne", 0.1)
    pts, t = data.scans[0], data.scan_pt_times[0]
    assert len(pts) == 16 * 60
    np.testing.assert_array_equal(tsim.ring_of(pts, sim_cfg),
                                  np.arange(len(pts)) % 16)
    velo = tsim.pointcloud2_fields(pts, t, "velodyne", sim_cfg)
    assert list(velo) == ["x", "y", "z", "intensity", "time", "ring"]
    np.testing.assert_array_equal(velo["time"], (t * 1e3).astype(np.float32))
    assert not tsim.pointcloud2_fields(pts, t, "velodyne_no_time",
                                       sim_cfg)["time"].any()
    ouster = tsim.pointcloud2_fields(pts, t, "ouster", sim_cfg)
    assert ouster["t"].dtype == np.uint32 and ouster["ring"].dtype == np.uint8
    np.testing.assert_array_equal(ouster["t"], np.rint(t * 1e9))
    assert list(tsim.pointcloud2_fields(pts, t, "marsim", sim_cfg)) == [
        "x", "y", "z", "intensity"]
    with pytest.raises(ValueError, match="unknown PointCloud2 kind"):
        tsim.write_pointcloud2_bag("unused.bag", data, "kitti", sim_cfg)


def _clouds(reader_mod, path):
    reader = reader_mod.BagReader(path)
    try:
        return [msg for _, mtype, _, msg in reader.messages()
                if mtype == "sensor_msgs/PointCloud2"]
    finally:
        reader.close()


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("kind,features", [
    ("velodyne", False), ("velodyne", True), ("velodyne_no_time", False),
    ("ouster", False), ("marsim", False)])
def test_decoded_scans_equal_jaxs(tmp_path, kind, features, native):
    """Each kind's bag read by both packages' readers (every field equal)
    and decoded by both packages' decoders, at the kind's preset (with
    feature extraction, Velodyne's surface cloud): the RawScans bit-equal."""
    preset = PRESET_OF[kind]
    sim_cfg, data = _sim(preset, 0.3)
    bag = tmp_path / f"{kind}.bag"
    tsim.write_pointcloud2_bag(bag, data, kind, sim_cfg)
    got, want = _clouds(trosbag, bag), _clouds(jrosbag, bag)
    assert len(got) == len(want) == len(data.scans)
    tcfg = dataclasses.replace(tconfig.PRESETS[preset],
                               feature_extract_enable=features)
    jcfg = dataclasses.replace(jconfig.PRESETS[preset],
                               feature_extract_enable=features)
    if native:
        assert tnative.available() and jnative.available()
    for mt, mj in zip(got, want):
        assert mt.keys() == mj.keys()
        for key in mj:
            np.testing.assert_array_equal(mt[key], mj[key], err_msg=key)
        st = tdrivers.decode(mt, tcfg, use_native=native)
        sj = jdrivers.decode(mj, jcfg, use_native=native)
        assert len(st.pts) > 0.2 * len(mt["xyz"])
        for field in ("pts", "time_offset_s", "intensity"):
            a, b = getattr(st, field), getattr(sj, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    if kind == "velodyne_no_time":  # the offsets reconstructed, ahead
        assert 0.0 < st.time_offset_s.min() and st.time_offset_s.max() < 0.1
    if kind == "marsim":
        assert not st.time_offset_s.any()


def _run(main, argv):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert main(argv) == 0
    return printed.getvalue()


@pytest.mark.parametrize("name", sorted(scenarios.POINTCLOUD2_BAGS))
def test_runner_replays_the_bag_as_jaxs(tmp_path, monkeypatch, name):
    """The bag through ``fast_lio_tpu.cli`` and ``fast_lio_tpu_torch.cli
    --platform cpu`` with ``scenarios.bag_argv``'s flags (feature extraction
    on the timed Velodyne bag, the extrinsic estimate off on Ouster's, the
    pose log on MARSIM's), each preset cut to small pads: the same scans,
    positions within 5 mm; the pose log written."""
    kind, preset, _ = scenarios.POINTCLOUD2_BAGS[name]
    monkeypatch.setitem(tconfig.PRESETS, preset, dataclasses.replace(
        tconfig.PRESETS[preset], **SMALL))
    monkeypatch.setitem(jconfig.PRESETS, preset, dataclasses.replace(
        jconfig.PRESETS[preset], **SMALL))
    sim_cfg, data = _sim(preset, 1.0)
    bag = tmp_path / "run.bag"
    tsim.write_pointcloud2_bag(bag, data, kind, sim_cfg)
    out = {}
    for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
        out[pkg] = tmp_path / pkg
        argv = scenarios.bag_argv(name, bag, out[pkg])
        _run(main, argv + (["--platform", "cpu"] if pkg == "port" else []))
    port, jax_ = (np.loadtxt(out[p] / "trajectory_tum.txt", ndmin=2)
                  for p in ("port", "jax"))
    assert port.shape == jax_.shape and len(port) >= 7
    np.testing.assert_array_equal(port[:, 0], jax_[:, 0])
    np.testing.assert_allclose(port[:, 1:4], jax_[:, 1:4], rtol=0,
                               atol=POS_TOL_M)
    if "--runtime-pos-log" in scenarios.bag_argv(name, bag, "-"):
        rows = np.loadtxt(out["port"] / "pos_log.txt", ndmin=2)
        assert len(rows) == len(port) and np.isfinite(rows).all()

"""Checkpoints across the two packages: a JAX checkpoint resumes in the
port, a port checkpoint resumes in the JAX package, and the port's own save,
load and resume equal its uninterrupted run; the PCD writers and reader give
the JAX package's files.

Tolerances: a resumed run in the other package is held to the f32 pipeline
tolerance of ROADMAP.md section C (5 mm per scan); the port resumed in the
port is the same code on the same state, so on the CPU it is bit-equal.
"""
import dataclasses

import numpy as np
import torch

from fast_lio_tpu import sim as simlib
from fast_lio_tpu.config import Config as JConfig
from fast_lio_tpu.config import LidarType as JLidarType
from fast_lio_tpu.pipeline import Pipeline as JPipeline
from fast_lio_tpu.pipeline import ScanPacket as JScanPacket
from fast_lio_tpu.utils import checkpoint as jckpt
from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch.utils import checkpoint as tckpt
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(filter_size_surf=0.3, filter_size_map=0.3, n_points_max=2048,
          n_ds_max=1024, n_imu_max=32, map_h_log2=12, det_range=40.0,
          cube_side_length=300.0)
SYNC_FIELDS = ("mean_scantime", "scan_num", "last_timestamp_lidar",
               "last_timestamp_imu")


def _data():
    return simlib.generate(simlib.SimConfig(duration=1.5, n_rings=8,
                                            n_azimuth=200, range_noise=0.01))


def _push(pipe, data, k_from, k_to, imu_i):
    """Push scans k_from..k_to-1 (and the IMU up to each) into pipe.sync;
    returns the next IMU index."""
    for k in range(k_from, k_to):
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pipe.sync.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                               data.imu_gyr[imu_i])
            imu_i += 1
        pipe.sync.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
    return imu_i


def _drain_both(src, dst, to_dst):
    """Pop every ready packet of src's sync; process it in src and, converted
    by to_dst, in dst.  Returns the (src, dst) positions per packet."""
    out = []
    while (pkt := src.sync.pop_packet()) is not None:
        src.process_packet(pkt)
        dst.process_packet(to_dst(**dataclasses.asdict(pkt)))
        out.append((src.get_trajectory()[-1][1], dst.get_trajectory()[-1][1]))
    return out


def _assert_same_restore(restored, saved):
    for f in SYNC_FIELDS:
        assert getattr(restored.sync, f) == getattr(saved.sync, f), f
    li_r, li_s = restored.sync.last_imu, saved.sync.last_imu
    assert li_r[0] == li_s[0]
    np.testing.assert_array_equal(li_r[1], li_s[1])
    for f in ("acc_scale", "first_lidar_time", "last_lidar_end_time",
              "map_built", "imu_need_init", "truncated_points"):
        assert getattr(restored, f) == getattr(saved, f), f
    assert restored.imu_stats.n == saved.imu_stats.n
    np.testing.assert_array_equal(np.asarray(restored.map.packed),
                                  np.asarray(saved.map.packed))
    for a, b in zip(restored.lm_state, saved.lm_state):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    data = _data()
    pj = JPipeline(JConfig(lidar_type=JLidarType.AVIA, **KW))
    imu_i = _push(pj, data, 0, 8, 0)
    while pj.spin_once():
        pass
    jckpt.save_pipeline(tmp_path / "jax.npz", pj)
    pt = tpipe.Pipeline(tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **KW),
                        device="cpu")
    tckpt.load_pipeline(tmp_path / "jax.npz", pt)
    _assert_same_restore(pt, pj)
    _push(pj, data, 8, len(data.scans), imu_i)
    pos = _drain_both(pj, pt, tpipe.ScanPacket)
    assert len(pos) >= 5
    for pj_pos, pt_pos in pos:
        np.testing.assert_allclose(pt_pos, pj_pos, rtol=0, atol=5e-3)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    data = _data()
    pt = tpipe.Pipeline(tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **KW),
                        device="cpu")
    imu_i = _push(pt, data, 0, 8, 0)
    while pt.spin_once():
        pass
    tckpt.save_pipeline(tmp_path / "port.npz", pt)
    pj = JPipeline(JConfig(lidar_type=JLidarType.AVIA, **KW))
    jckpt.load_pipeline(tmp_path / "port.npz", pj)
    _assert_same_restore(pj, pt)
    _push(pt, data, 8, len(data.scans), imu_i)
    pos = _drain_both(pt, pj, JScanPacket)
    assert len(pos) >= 5
    for pt_pos, pj_pos in pos:
        np.testing.assert_allclose(pj_pos, pt_pos, rtol=0, atol=5e-3)


def test_port_resume_equals_uninterrupted_run(tmp_path):
    data = _data()
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **KW)
    ref = tpipe.Pipeline(cfg, device="cpu")
    _push(ref, data, 0, len(data.scans), 0)
    while ref.spin_once():
        pass

    pipe = tpipe.Pipeline(cfg, device="cpu")
    imu_i = _push(pipe, data, 0, 9, 0)
    while pipe.spin_once():
        pass
    tckpt.save_pipeline(tmp_path / "ck.npz", pipe)
    resumed = tpipe.Pipeline(cfg, device="cpu")
    meta = tckpt.load_pipeline(tmp_path / "ck.npz", resumed)
    assert int(meta["scan_num"]) == pipe.sync.scan_num
    _assert_same_restore(resumed, pipe)
    # the in-flight sensor queues belong to the transport, not the
    # checkpoint: hand them over as the host would
    for f in ("lidar_buf", "imu_t", "imu_acc", "imu_gyr"):
        setattr(resumed.sync, f, list(getattr(pipe.sync, f)))
    _push(resumed, data, 9, len(data.scans), imu_i)
    while resumed.spin_once():
        pass
    n = len(resumed.trajectory)
    assert n >= 5
    got = np.stack([p for _, p, _ in resumed.get_trajectory()])
    want = np.stack([p for _, p, _ in ref.get_trajectory()[-n:]])
    np.testing.assert_array_equal(got, want)
    assert torch.equal(resumed.map.packed, ref.map.packed)


def test_pcd_files_match_jax(tmp_path):
    rng = np.random.default_rng(95)
    scans = [(rng.normal(size=(n, 3)).astype(np.float32),
              rng.uniform(0, 255, n).astype(np.float32)) for n in (40, 0, 25, 60)]
    for mod, name in ((tckpt, "port"), (jckpt, "jax")):
        acc = mod.PcdAccumulator(tmp_path / name, save_interval=2)
        for pts, inten in scans:
            acc.add(pts, inten)
        acc.add(scans[0][0])  # no intensity: zeros
        acc.finish()
        mod.save_pcd(tmp_path / name / "xyz.pcd", scans[2][0])
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == ["scans.pcd", "scans_1.pcd", "scans_2.pcd", "xyz.pcd"]
    for f in files:
        raw = (tmp_path / "port" / f).read_bytes()
        assert raw == (tmp_path / "jax" / f).read_bytes(), f
        np.testing.assert_array_equal(tckpt.load_pcd(tmp_path / "jax" / f),
                                      jckpt.load_pcd(tmp_path / "port" / f))
    np.testing.assert_array_equal(
        tckpt.load_pcd(tmp_path / "port" / "scans_1.pcd"), scans[0][0])

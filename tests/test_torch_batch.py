"""The port's ``BatchPipeline`` (lockstep fleet replay) against B single
port ``Pipeline``s and against the JAX package's ``BatchPipeline``, mirroring
tests/test_batch.py: two streams, the second shorter, so the rounds after it
ends run without it (the JAX package runs a no-op lane there).

Tolerances: each lane of the port's batch is the single-stream step on the
same packets, run under ``torch.func.vmap``.  There the step's
matrix-vector products run as batched matrix products, which round
differently from a single product, so a lane is not bit-equal to a single
``Pipeline``: over this run they part by at most 8.0e-5 m (measured on a
CPU), held here to BATCH_VS_SINGLE_M.  Against the JAX package's vmapped
batch the f32 pipeline tolerance of ROADMAP.md section C holds (5 mm per
scan).
"""
import numpy as np
import pytest

from fast_lio_tpu import sim as simlib
from fast_lio_tpu.batch import BatchPipeline as JBatchPipeline
from fast_lio_tpu.config import Config as JConfig
from fast_lio_tpu.config import LidarType as JLidarType
from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch.batch import BatchPipeline
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# a lane against a single Pipeline on the same packets (measured 8.0e-5 m)
BATCH_VS_SINGLE_M = 5e-4

KW = dict(filter_size_surf=0.3, filter_size_map=0.3, n_points_max=2048,
          n_ds_max=1024, n_imu_max=32, map_h_log2=12, det_range=40.0,
          cube_side_length=300.0)


def _gen(seed, duration):
    return simlib.generate(simlib.SimConfig(
        duration=duration, n_rings=8, n_azimuth=120, range_noise=0.005,
        seed=seed))


def _feed_single(pipe, data):
    imu_i = 0
    for k in range(len(data.scans)):
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while pipe.spin_once():
            pass
    return pipe


def _feed_batch(bp, datas):
    imu_i = [0] * len(datas)
    rounds = 0
    for k in range(max(len(d.scans) for d in datas)):
        for i, d in enumerate(datas):
            if k >= len(d.scans):
                bp.mark_done(i)
                continue
            stamp = d.scan_stamps[k]
            while imu_i[i] < len(d.imu_t) and d.imu_t[imu_i[i]] <= stamp + 0.1 + 1e-9:
                bp.push_imu(i, d.imu_t[imu_i[i]], d.imu_acc[imu_i[i]],
                            d.imu_gyr[imu_i[i]])
                imu_i[i] += 1
            bp.push_lidar(i, stamp, d.scans[k], d.scan_pt_times[k])
        while bp.spin_once():
            rounds += 1
    return rounds


def _positions(traj):
    return np.stack([p for _, p, _ in traj])


def test_batch_matches_single_pipelines_and_jax_batch():
    datas = [_gen(0, 1.5), _gen(1, 1.0)]  # stream 1 is SHORTER
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **KW)
    singles = [_feed_single(tpipe.Pipeline(cfg, device="cpu"), d)
               for d in datas]
    bp = BatchPipeline(cfg, 2, device="cpu")
    rounds = _feed_batch(bp, datas)
    jbp = JBatchPipeline(JConfig(lidar_type=JLidarType.AVIA, **KW), 2)
    _feed_batch(jbp, datas)

    assert bp.imu_need_init == [False, False]
    assert bp.truncated_points == [0, 0]
    n = [len(bp.get_trajectory(i)) for i in range(2)]
    assert n[1] < n[0] == rounds  # rounds after stream 1 ended
    for i in range(2):
        traj = bp.get_trajectory(i)
        single = singles[i].get_trajectory()
        assert [t for t, _, _ in traj] == [t for t, _, _ in single]
        np.testing.assert_allclose(_positions(traj), _positions(single),
                                   rtol=0, atol=BATCH_VS_SINGLE_M)
        jtraj = jbp.get_trajectory(i)
        assert [t for t, _, _ in traj] == [t for t, _, _ in jtraj]
        np.testing.assert_allclose(_positions(traj), _positions(jtraj),
                                   rtol=0, atol=5e-3)
        diags, jdiags = bp.get_diags(i), jbp.get_diags(i)
        assert len(diags) == len(jdiags) == n[i]
        assert [d.iterations for d in diags] == [
            int(d.iterations) for d in singles[i].diags]
        assert all(d.total_time > 0 for d in diags)


def test_lockstep_waits_for_every_stream():
    datas = [_gen(0, 0.6), _gen(1, 0.6)]
    bp = BatchPipeline(tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **KW), 2,
                       device="cpu")
    _feed_batch(bp, datas[:1] + [simlib.SimData(
        scan_stamps=np.zeros(0), scans=[], scan_pt_times=[],
        imu_t=np.zeros(0), imu_acc=np.zeros((0, 3)), imu_gyr=np.zeros((0, 3)),
        gt_pos=np.zeros((0, 3)), gt_rot=np.zeros((0, 3, 3)))])
    # stream 1 was marked done at once, but never initialized: stream 0 runs
    assert len(bp.get_trajectory(0)) > 0 and not bp.get_trajectory(1)
    with pytest.raises(ValueError):
        BatchPipeline(tcfg.PRESETS["avia"], 0, device="cpu")

"""The slice as a whole: the same simulated run through the JAX pipeline and
the port's, on the CPU.

Tolerances: in f64 the two pipelines do the same arithmetic, so per-scan
positions agree to 1e-6 m with equal effective-point and iteration counts;
in f32 rounding differs at the ulp level (another summation order in the
downsample, the IMU chain and the filter's solves), which a 3-iteration
Gauss-Newton fit can carry to the 1e-5 m level, so positions agree to 5 mm.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fast_lio_tpu import sim as simlib
from fast_lio_tpu.config import Config as JConfig
from fast_lio_tpu.config import LidarType as JLidarType
from fast_lio_tpu.pipeline import Pipeline as JPipeline
from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import convert
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch.map import hash_map as thm
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

POS_TOL = {"float32": 5e-3, "float64": 1e-6}

SMALL = dict(n_points_max=2048, n_ds_max=1024, map_h_log2=12)


def _feed(pipe, data, scans=None):
    imu_i = 0
    for k in range(len(data.scans) if scans is None else scans):
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while pipe.spin_once():
            pass
    return imu_i


def _configs(**kw):
    j = dataclasses.replace(JConfig(lidar_type=JLidarType.AVIA, **kw))
    t = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **kw)
    return j, t


def _positions(pipe):
    return np.stack([p for _, p, _ in pipe.get_trajectory()])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_small_avia_run_matches_jax(dtype):
    jc, tc = _configs(det_range=450.0, compute_dtype=dtype, **SMALL)
    data = simlib.generate(simlib.SimConfig(duration=1.6, n_rings=8,
                                            n_azimuth=200, range_noise=0.01))
    pj, pt = JPipeline(jc), tpipe.Pipeline(tc, device="cpu")
    _feed(pj, data)
    _feed(pt, data)
    pos_j, pos_t = _positions(pj), _positions(pt)
    assert len(pos_j) == len(pos_t) >= 14
    np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=POS_TOL[dtype])
    if dtype == "float64":
        assert [int(d.n_effective) for d in pt.diags] == [
            int(d.n_effective) for d in pj.diags]
        assert [int(d.iterations) for d in pt.diags] == [
            int(d.iterations) for d in pj.diags]
        np.testing.assert_allclose(pt.pose_covariance(), pj.pose_covariance(),
                                   rtol=1e-6, atol=1e-12)
        wj, ij = pj.last_cloud_world_dense()
        wt, it = pt.last_cloud_world_dense()
        np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(it, ij)
    hj, ht = pj.health_check(), pt.health_check()
    assert not ht["nan"] and ht["p_min_eig"] > 0
    for key in ("scans", "truncated_points", "imu_initialized", "map_built",
                "map_dropped"):
        assert ht[key] == hj[key], key
    assert abs(ht["map_size"] - hj["map_size"]) <= (0 if dtype == "float64" else 8)
    assert (simlib.ate_rmse(pt.get_trajectory(), data)
            <= simlib.ate_rmse(pj.get_trajectory(), data) + 1e-3)


def test_sparse_outdoor_run_with_wide_fallback_matches_jax(monkeypatch):
    """The tests/test_sparse_regime.py outdoor geometry (far walls, sparse
    returns) with cell = 5 voxels and the wide fallback, cut to 1.5 s.  A
    small partial-wide budget makes the fallback take both wide arms: the
    unsaturated rows only (at most the budget) and every row (more)."""
    world = simlib.World(
        room_lo=np.array([-40.0, -20.0, 0.0]),
        room_hi=np.array([50.0, 70.0, 12.0]),
        pillars=(
            (np.array([-10.0, 8.0, 0.0]), np.array([-7.0, 11.0, 12.0])),
            (np.array([12.0, 25.0, 0.0]), np.array([15.5, 28.5, 12.0])),
        ),
    )
    data = simlib.generate(
        simlib.SimConfig(duration=1.5, n_rings=16, n_azimuth=320,
                         elev_min=-22.0, elev_max=8.0, max_range=100.0,
                         range_noise=0.01),
        traj=simlib.Trajectory(radius=12.0, omega=0.4), world=world)
    kw = dict(filter_size_surf=0.5, filter_size_map=0.5, n_points_max=8192,
              n_ds_max=4096, n_imu_max=32, map_h_log2=12, det_range=100.0,
              cube_side_length=600.0, knn_wide_fallback=True,
              map_cell_multiplier=5, knn_wide_max_queries=512)
    jc, tc = _configs(**kw)

    wide_sizes = []
    search = tpipe.knn_kernel.knn_search

    def counting(m, cfg, q, k=5, wide=False):
        if wide:
            wide_sizes.append(q.shape[0])
        return search(m, cfg, q, k=k, wide=wide)

    arms = []
    fallback = tpipe.wide_fallback

    def recording(base, queries, mask, rcov2, K_w):
        narrow = []

        def base_kept(q, wide=False):
            out = base(q, wide)
            if not wide:
                narrow.append(out)
            return out

        out = fallback(base_kept, queries, mask, rcov2, K_w)
        _nb, sq, found = narrow[0]
        arms.append((int(torch.sum((~found[:, -1] | (sq[:, -1] > rcov2))
                                   & mask)), K_w))
        return out

    monkeypatch.setattr(tpipe.knn_kernel, "knn_search", counting)
    monkeypatch.setattr(tpipe, "wide_fallback", recording)
    pj, pt = JPipeline(jc), tpipe.Pipeline(tc, device="cpu")
    _feed(pj, data)
    _feed(pt, data)
    np.testing.assert_allclose(_positions(pt), _positions(pj), rtol=0,
                               atol=POS_TOL["float32"])
    assert any(0 < n <= k for n, k in arms)  # the unsaturated rows only
    assert any(n > k for n, k in arms)  # every row
    assert set(wide_sizes) == {4096}  # the full wide search serves both
    assert pt.health_check()["map_dropped"] == pj.health_check()["map_dropped"]


def _jax_state_arrays(pj):
    arrays = {f: np.asarray(v) for f, v in zip(pj.x._fields, pj.x)}
    arrays.update(
        P=np.asarray(pj.P), map_packed=np.asarray(pj.map.packed),
        map_dropped=np.asarray(pj.map.dropped),
        angvel_last=np.asarray(pj.imu_carry.angvel_last),
        acc_s_last=np.asarray(pj.imu_carry.acc_s_last),
        lm_lo=np.asarray(pj.lm_state[0]), lm_hi=np.asarray(pj.lm_state[1]),
        lm_init=np.asarray(pj.lm_state[2]), acc_scale=pj.acc_scale,
        first_lidar_time=pj.first_lidar_time,
        last_lidar_end_time=pj.last_lidar_end_time, map_built=pj.map_built,
        imu_need_init=pj.imu_need_init)
    return arrays


def test_handover_from_jax_mid_run():
    """The JAX pipeline runs 8 scans; its state is loaded into the port,
    and the next scans, as the same synced packets, give the same poses."""
    jc, tc = _configs(det_range=450.0, **SMALL)
    data = simlib.generate(simlib.SimConfig(duration=1.2, n_rings=8,
                                            n_azimuth=200, range_noise=0.01))
    pj = JPipeline(jc)
    imu_i = _feed(pj, data, scans=8)
    pt = tpipe.Pipeline(tc, device="cpu")
    arrays = _jax_state_arrays(pj)
    assert set(arrays) == set(convert.KEYS)
    convert.load_numpy_state(pt, arrays)
    np.testing.assert_array_equal(pt.map.packed.numpy(), arrays["map_packed"])
    n_run = 0
    for k in range(8, len(data.scans)):
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pj.sync.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                             data.imu_gyr[imu_i])
            imu_i += 1
        pj.sync.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while (pkt := pj.sync.pop_packet()) is not None:
            pj.process_packet(pkt)
            pt.process_packet(tpipe.ScanPacket(**dataclasses.asdict(pkt)))
            n_run += 1
            np.testing.assert_allclose(pt.get_trajectory()[-1][1],
                                       pj.get_trajectory()[-1][1], rtol=0,
                                       atol=POS_TOL["float32"])
            assert int(pt.diags[-1].iterations) == int(pj.diags[-1].iterations)
    assert n_run >= 3
    with pytest.raises(KeyError):
        convert.load_numpy_state(pt, {k: v for k, v in arrays.items()
                                      if k != "P"})


def test_pad_truncation_is_counted():
    _jc, tc = _configs(n_points_max=1024, n_ds_max=512, map_h_log2=10)
    data = simlib.generate(simlib.SimConfig(duration=0.6, n_rings=8,
                                            n_azimuth=200))
    pt = tpipe.Pipeline(tc, device="cpu")
    with pytest.warns(UserWarning, match="exceeds the largest pad"):
        _feed(pt, data)
    # the first scan goes to IMU init and is not padded
    expect = sum(max(0, len(s) - 1024) for s in data.scans[1:])
    assert expect > 0
    assert pt.health_check()["truncated_points"] == expect
    assert [d.n_truncated for d in pt.diags] == [
        max(0, len(s) - 1024) for s in data.scans[1:]]
    pt2 = tpipe.Pipeline(dataclasses.replace(tc, pad_buckets=(512, 4096)),
                         device="cpu")
    assert [pt2._pad_for(n) for n in (10, 512, 513, 5000)] == [512, 512, 4096, 4096]


def test_device_selection_and_unported_options():
    cfg = tcfg.PRESETS["avia"]
    if torch.cuda.is_available():
        assert tpipe.Pipeline(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpipe.Pipeline(cfg)
    small = dataclasses.replace(cfg, **SMALL)
    assert tpipe.Pipeline(small, device="cpu").map.packed.device.type == "cpu"
    # every option of the JAX package's single-device pipeline is ported:
    # rescore_research (test_torch_rescore.py), the stage timers
    # (test_torch_stage_timing.py), and the grouped backend besides
    for opt in (dict(rescore_research=True), dict(knn_backend="grouped"),
                dict(knn_backend="xla")):
        tpipe.Pipeline(dataclasses.replace(small, **opt), device="cpu")
    with pytest.raises(ValueError, match="knn_backend"):
        tpipe.Pipeline(dataclasses.replace(small, knn_backend="pallas"),
                       device="cpu")
    assert set(tpipe.Pipeline(small, device="cpu").measure_stage_times()) == {
        "search", "incremental", "delete"}
    with pytest.raises(ValueError, match="h_log2"):
        tpipe.Pipeline(dataclasses.replace(small, map_h_log2=16), device="cpu")
    assert isinstance(tpipe.Pipeline(small, device="cpu").map, thm.Map)

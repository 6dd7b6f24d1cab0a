"""Stage timers of the port (``Pipeline.measure_stage_times``), mirroring
tests/test_stage_timing.py: the search column times the CONFIGURED backend
with its wide fallback, every stage is a positive time, the measurement
leaves the live map alone, and ``--stage-timing`` fills the timing CSV's
search / incremental / delete columns.  On the CPU these are host-clock
times of the plain versions; on CUDA the same code times with CUDA events.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fast_lio_tpu_torch import cli
from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch import sim as tsim
from fast_lio_tpu_torch.kernels import knn as tknn
from fast_lio_tpu_torch.kernels import knn_grouped as tkg
from fast_lio_tpu_torch.map import hash_map as thm
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _run(cfg):
    data = tsim.generate(tsim.SimConfig(duration=1.5, n_rings=8,
                                        n_azimuth=100))
    pipe = tpipe.Pipeline(cfg, device="cpu")
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


@pytest.mark.parametrize("mode", ["auto", "grouped", "rescore"])
def test_stage_times_positive_with_wide_fallback(mode, monkeypatch):
    cfg = tcfg.Config(
        lidar_type=tcfg.LidarType.AVIA, filter_size_surf=0.3,
        filter_size_map=0.3, n_points_max=1024, n_ds_max=512, n_imu_max=32,
        map_h_log2=11, det_range=40.0, cube_side_length=300.0,
        map_cell_multiplier=5, knn_wide_fallback=mode != "rescore",
        stage_timing=True, rescore_research=mode == "rescore",
        knn_backend="grouped" if mode == "grouped" else "auto")
    pipe = _run(cfg)
    packed = pipe.map.packed.clone()
    searched = []
    mod, name = {"auto": (tknn, "knn_search"),
                 "grouped": (tkg, "knn_search"),
                 "rescore": (thm, "knn_search")}[mode]
    search = getattr(mod, name)

    def counting(m, c, q, k=5, wide=False, **kw):
        searched.append(wide)
        return search(m, c, q, k=k, wide=wide, **kw)

    monkeypatch.setattr(mod, name, counting)
    st = pipe.measure_stage_times()
    assert set(st) == {"search", "incremental", "delete"}
    for k, v in st.items():
        assert v > 0, (k, v)
    # the configured search is timed, with the wide fallback where it is on
    assert searched and (True in searched) == (mode != "rescore")
    assert torch.equal(pipe.map.packed, packed)  # the live map is untouched
    # stage_timing mode records real synced per-scan latency
    assert all(d.total_time > 0 for d in pipe.diags)


def test_stage_timing_fills_the_csv_columns(tmp_path):
    out = tmp_path / "out"
    assert cli.main(["--sim", "--duration", "0.6", "--platform", "cpu",
                     "--stage-timing", "--out", str(out)]) == 0
    csv = np.genfromtxt(out / "fast_lio_time_log.csv", delimiter=",",
                        skip_header=2, ndmin=2)
    assert len(csv) >= 4
    # incremental time, search time, delete time (reference column order)
    for col in (3, 4, 6):
        assert (csv[:, col] > 0).all() and len(set(csv[:, col])) == 1
    assert (csv[:, 1] > 0).all()  # per-scan total time
    off = tmp_path / "off"
    assert cli.main(["--sim", "--duration", "0.6", "--platform", "cpu",
                     "--out", str(off)]) == 0
    csv_off = np.genfromtxt(off / "fast_lio_time_log.csv", delimiter=",",
                            skip_header=2, ndmin=2)
    assert (csv_off[:, [3, 4, 6]] == 0).all()
    assert dataclasses.replace(tcfg.PRESETS["avia"]).stage_timing is False


def test_stage_timing_leaves_the_outputs_alone(tmp_path):
    """The runner times the stages after the replay and before it writes
    the map and the checkpoint: the timers work on a copy, so the
    trajectory, map and checkpoint equal those of a run without them."""
    outs = {}
    for name, extra in (("timed", ["--stage-timing"]), ("plain", [])):
        outs[name] = tmp_path / name
        assert cli.main(["--sim", "--duration", "0.6", "--platform", "cpu",
                         "--checkpoint", "--map-save", "--out",
                         str(outs[name])] + extra) == 0
    for f in ("trajectory_tum.txt", "map.pcd"):
        assert ((outs["timed"] / f).read_bytes()
                == (outs["plain"] / f).read_bytes()), f
    with np.load(outs["timed"] / "checkpoint.npz") as a, \
            np.load(outs["plain"] / "checkpoint.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

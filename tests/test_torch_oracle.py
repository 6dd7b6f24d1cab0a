"""The port's f64 oracle (``fast_lio_tpu_torch/oracle.py``) and the port's
pipeline held to it, on the oracle-trace stream of
tests/test_oracle_trace.py (its config and sim run), cut to its first
``PACKETS`` packets: the oracle's brute-force kNN takes about 2.5 s a
packet here as the map grows, so each oracle mode runs once, in a module
fixture.

* The port's oracle against the JAX package's on the first
  ``JAX_PACKETS`` packets, both modes: poses bit-equal (the same numpy
  code).  The oracle is sequential, so its first poses do not depend on
  later packets, and the JAX oracle runs on those packets only.
* The port's CPU pipeline in float32 and float64 against the oracle.
  Intended mode: tests/test_oracle_trace.py's bounds (position 10 mm max,
  5 mm median; rotation 5 mrad).  Reference mode (quirks): 35 mm and
  10 mrad, ATE within 1.5 cm of the oracle's.  Float64 has its own bounds:
  twice what it measured (ROADMAP.md C), each no looser than float32's.
"""
import numpy as np
import pytest

from fast_lio_tpu_torch import sim
from fast_lio_tpu_torch.tools import oracle_compare as oc
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

PACKETS = 12
JAX_PACKETS = 4

# (pos max m, pos median m, rot max rad, |ATE difference| m) by mode; None:
# not held.  tests/test_oracle_trace.py's bounds for float32
BOUNDS = {
    "float32": {"intended": (0.010, 0.005, 0.005, None),
                "reference": (0.035, None, 0.010, 0.015)},
    # measured on this stream: 1.47 mm, 0.32 mm, 0.32 mrad (intended);
    # 18.1 mm, 2.33 mrad, 3.05 mm (reference); twice that, rounded up, and
    # float32's where twice is looser (reference position: 36.2 mm)
    "float64": {"intended": (0.003, 0.0007, 0.0007, None),
                "reference": (0.035, None, 0.005, 0.007)},
}


@pytest.fixture(scope="module")
def stream():
    cfg = oc.make_cfg()
    data = oc.make_data()
    return cfg, data, oc.packets_of(data, cfg, PACKETS)


@pytest.fixture(scope="module")
def oracles(stream):
    cfg, _data, pkts = stream
    return {name: oc.run_oracle(cfg, pkts, **mode)
            for name, mode in oc.MODES.items()}


_PIPELINES = {}


def _pipeline(dtype, pkts):
    """The port's CPU trajectory on the stream (run once per dtype, inside
    the first test that asks, with one torch thread)."""
    if dtype not in _PIPELINES:
        _PIPELINES[dtype] = oc.run_pipeline(oc.make_cfg(dtype), pkts,
                                            device="cpu")
    return _PIPELINES[dtype]


@pytest.mark.parametrize("mode", list(oc.MODES))
def test_oracle_is_the_jax_packages_on_the_same_packets(stream, oracles, mode):
    from fast_lio_tpu.config import Config as JConfig
    from fast_lio_tpu.config import LidarType as JLidarType
    from fast_lio_tpu.oracle import OracleLIO as JOracle

    cfg, _data, pkts = stream
    jcfg = JConfig(lidar_type=JLidarType.AVIA, filter_size_surf=0.3,
                   filter_size_map=0.3, n_points_max=8192, n_ds_max=4096,
                   n_imu_max=32, map_h_log2=13, det_range=40.0,
                   cube_side_length=300.0, knn_backend="xla")
    orc = JOracle(jcfg, **oc.MODES[mode])
    for p in pkts[:JAX_PACKETS]:
        orc.process_packet(p)
    want = orc.trajectory
    assert len(want) >= JAX_PACKETS - 2
    got = oracles[mode][:len(want)]
    for (t1, p1, q1), (t2, p2, q2) in zip(got, want):
        assert t1 == t2
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(q1, q2)


@pytest.mark.parametrize("mode", list(oc.MODES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pipeline_stays_within_the_oracle_bounds(stream, oracles, dtype,
                                                 mode):
    _cfg, data, pkts = stream
    traj = _pipeline(dtype, pkts)
    traj_o = oracles[mode]
    assert len(traj_o) >= PACKETS - 3
    dp, dr = oc.deltas(traj, traj_o)
    assert len(dp) == len(traj_o)
    pos_max, pos_med, rot_max, d_ate = BOUNDS[dtype][mode]
    assert dp.max() < pos_max, f"pos delta {dp.max() * 1e3:.3f} mm"
    if pos_med is not None:
        assert np.median(dp) < pos_med
    assert dr.max() < rot_max, f"rot delta {dr.max() * 1e3:.3f} mrad"
    if d_ate is not None:
        assert abs(sim.ate_rmse(traj, data) - sim.ate_rmse(traj_o, data)) < d_ate


def test_float64_bounds_are_no_looser_than_float32s():
    for mode, b64 in BOUNDS["float64"].items():
        for a, b in zip(b64, BOUNDS["float32"][mode]):
            assert (a is None) == (b is None) and (a is None or a <= b)

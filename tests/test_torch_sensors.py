"""The sensors the JAX package supports beyond avia and ouster64, through
the port's packet API against the JAX package's, on the CPU: the MARSIM
preset's undeskewed step, bench.py's mid360 scenario, and the port's sim
shapes that fit the presets (``sim.SimConfig.spin`` and ``fov_deg``,
``tools/scenarios.preset_run``).

Tolerances: in f64 the two pipelines do the same arithmetic, so state and
covariance agree to 1e-8 after every scan, with equal iterations; in f32
positions agree to 5 mm a scan (ROADMAP.md section C).  The sim at its
defaults is the JAX package's sim bit for bit.

On a card (marked ``cuda``; they skip without one): the MARSIM preset's
captured step against its eager one, and the mid360 scenario's steady state
with no host sync.  The card's host has no JAX, so this file imports it
lazily: ``python -m pytest -p no:cacheprovider --noconftest -m cuda
tests/test_torch_sensors.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch import sim as tsim
from fast_lio_tpu_torch.config import PRESETS as TPRESETS
from fast_lio_tpu_torch.config import LidarType
from fast_lio_tpu_torch.tools import scenarios
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

POS_TOL_M = 5e-3
F64_TOL = 1e-8
# the presets' pads and map cut to a small run's size
SMALL = dict(n_points_max=2048, n_ds_max=1024, n_imu_max=32, map_h_log2=11)


def _jax():
    """The JAX package's sim, presets and Pipeline (imported here: the
    card tests run where there is no JAX)."""
    from fast_lio_tpu import sim
    from fast_lio_tpu.config import PRESETS
    from fast_lio_tpu.pipeline import Pipeline
    return sim, PRESETS, Pipeline


def _steps(pipe, data):
    """Generator: each next() pushes one scan (with the IMU samples up to
    0.1 s after its stamp) and runs what it synced."""
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
        yield k


def _positions(pipe):
    return np.stack([np.asarray(p, np.float64)
                     for _, p, _ in pipe.get_trajectory()])


@pytest.mark.parametrize("shape", [{}, {"range_noise": 0.01, "seed": 3}])
def test_sim_at_its_defaults_is_jaxs(shape):
    """The port's sim with ``spin`` and ``fov_deg`` at their defaults makes
    the JAX package's runs bit for bit."""
    jsim, _, _ = _jax()
    kw = dict(duration=0.3, n_rings=8, n_azimuth=90, **shape)
    got = tsim.generate(tsim.SimConfig(**kw))
    want = jsim.generate(jsim.SimConfig(**kw))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


def test_spin_and_field_of_view_shape_the_sweep():
    """``spin=-1`` sweeps the azimuth clockwise (it falls as the scan's
    time grows); ``fov_deg`` sweeps only the field of view ahead, across
    the whole scan period."""
    base = dict(duration=0.2, n_rings=4, n_azimuth=72, range_noise=0.0)
    ccw = tsim.generate(tsim.SimConfig(**base))
    cw = tsim.generate(tsim.SimConfig(**base, spin=-1))
    fov = tsim.generate(tsim.SimConfig(**base, fov_deg=80.0))
    for data, sign in ((ccw, 1), (cw, -1)):
        pts, t = data.scans[0], data.scan_pt_times[0]
        az = np.unwrap(np.arctan2(pts[::4, 1], pts[::4, 0]))  # ring 0
        assert np.all(np.diff(t[::4]) > 0)
        assert np.all(sign * np.diff(az) > 0)
        assert abs(az[-1] - az[0]) == pytest.approx(2 * np.pi * 71 / 72,
                                                    rel=1e-4)
    pts, t = fov.scans[0], fov.scan_pt_times[0]
    az = np.rad2deg(np.arctan2(pts[:, 1], pts[:, 0]))
    assert az.min() == pytest.approx(-40.0, abs=1e-3)
    assert az.max() < 40.0 and az.max() > 38.0
    assert t.min() == 0.0 and t.max() == pytest.approx(0.1 * 71 / 72)
    np.testing.assert_array_equal(fov.imu_acc, ccw.imu_acc)
    np.testing.assert_array_equal(fov.gt_pos, ccw.gt_pos)


@pytest.mark.parametrize("name", sorted(scenarios.PRESET_SIMS))
def test_preset_runs_fit_their_presets(name):
    """Each preset run: the preset unchanged (every field the JAX
    package's), and a scan of the sensor's size that its pad holds."""
    _, JPRESETS, _ = _jax()
    cfg, sim_cfg, data = scenarios.preset_run(name, 0.1)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JPRESETS[name])
    assert sim_cfg.duration == 0.1 and len(data.scans) == 1
    scan = data.scans[0]
    want = {"horizon": 24000, "mid360": 20480, "velodyne": 28800,
            "marsim": 12800, "ouster64": 65536}[name]
    assert len(scan) == want <= 65536
    if name != "ouster64":  # its pad takes the decoded third (1 in 3)
        assert len(scan) <= cfg.n_points_max
    assert np.linalg.norm(scan, axis=1).max() <= sim_cfg.max_range
    with pytest.raises(ValueError, match="unknown preset run"):
        scenarios.preset_run("kitti")


def _state(pipe):
    """The state after a scan, as float64 arrays: each State field, P."""
    out = {f: np.asarray(v.cpu() if torch.is_tensor(v) else v, np.float64)
           for f, v in zip(pipe.x._fields, pipe.x)}
    out["P"] = np.asarray(pipe.P.cpu() if torch.is_tensor(pipe.P) else pipe.P,
                          np.float64)
    return out


def test_marsim_float64_step_matches_jax_scan_by_scan():
    """The MARSIM preset in float64 (small pads): the undeskewed step
    (``propagate_and_deskew(deskew=False)``), the packet end pinned to the
    scan's stamp and five filter passes at ``max_iteration=4``; after every
    scan the port's state and covariance within 1e-8 of JAX's and its
    iterations equal, some scan running all five passes."""
    _, JPRESETS, JPipeline = _jax()
    kw = dict(SMALL, compute_dtype="float64")
    tc = dataclasses.replace(TPRESETS["marsim"], **kw)
    jc = dataclasses.replace(JPRESETS["marsim"], **kw)
    assert tc.lidar_type == LidarType.MARSIM and tc.max_iteration == 4
    data = tsim.generate(tsim.SimConfig(duration=1.5, n_rings=12,
                                        n_azimuth=150, max_range=30.0))
    pj, pt = JPipeline(jc), tpipe.Pipeline(tc, device="cpu")
    checked = 0
    for _ in zip(_steps(pj, data), _steps(pt, data)):
        assert len(pt.trajectory) == len(pj.trajectory)
        if not pt.diags:
            continue
        assert int(pt.diags[-1].iterations) == int(pj.diags[-1].iterations)
        got, want = _state(pt), _state(pj)
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=0, atol=F64_TOL,
                                       err_msg=key)
        checked += 1
    assert checked >= 12
    # MARSIM's packet ends at its stamp: no deskew, no motion after it
    assert [t for t, _, _ in pt.get_trajectory()] == [
        t for t, _, _ in pj.get_trajectory()]
    assert pt.get_trajectory()[-1][0] in set(data.scan_stamps.tolist())
    its = [int(d.iterations) for d in pt.diags]
    assert max(its) == tc.max_iteration + 1, its


def test_mid360_scenario_matches_jax():
    """bench.py's mid360 scenario (100 Hz scans, 1024/512 pads, the
    partial-wide budget 128) for 0.1 s: every scan within 5 mm of JAX's."""
    _, JPRESETS, JPipeline = _jax()
    cfg, data = scenarios.scenario("mid360", 0.1)
    jcfg = dataclasses.replace(JPRESETS["mid360"], **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name not in ("lidar_type", "time_unit")})
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    pj, pt = JPipeline(jcfg), tpipe.Pipeline(cfg, device="cpu")
    for _ in zip(_steps(pj, data), _steps(pt, data)):
        pass
    a, b = _positions(pt), _positions(pj)
    assert a.shape == b.shape and len(a) >= 6
    np.testing.assert_allclose(a, b, rtol=0, atol=POS_TOL_M)
    assert [int(d.n_down) for d in pt.diags][1:] == [
        int(d.n_down) for d in pj.diags][1:]
    assert not pt.health_check()["nan"]


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_cuda_marsim_captured_equals_eager():
    """The MARSIM preset at full width on the card: the captured step (its
    at most five passes one WHILE node) within 5 mm of the eager, masked
    one."""
    _card()
    cfg, _, data = scenarios.preset_run("marsim", 1.5)
    runs = {}
    for graphs in (False, True):
        pipe = tpipe.Pipeline(cfg, graphs=graphs)
        for _ in _steps(pipe, data):
            pass
        runs[graphs] = pipe
    a, b = _positions(runs[False]), _positions(runs[True])
    assert a.shape == b.shape and len(a) >= 12 and np.isfinite(b).all()
    assert np.abs(a - b).max() <= POS_TOL_M
    stats = runs[True].graphs.stats()
    assert stats and all(s["gated"] and s["replays"] > 0
                         for s in stats.values())
    assert max(int(d.iterations) for d in runs[True].diags) <= 5


@pytest.mark.cuda
def test_cuda_mid360_scenario_steady_state_makes_no_sync():
    """bench.py's mid360 scenario at its widths, captured: after 6 scans
    the next ones run under ``set_sync_debug_mode("error")``."""
    _card()
    cfg, data = scenarios.scenario("mid360", 0.4)
    pipe = tpipe.Pipeline(cfg)
    steps = _steps(pipe, data)
    for _ in range(6):
        next(steps)
    assert pipe.map_built and pipe.graphs.stats()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in steps:
            pass
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(pipe.trajectory) >= len(data.scans) - 3
    assert np.isfinite(_positions(pipe)).all()

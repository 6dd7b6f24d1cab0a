"""The port's benchmark runner (``fast_lio_tpu_torch/tools/bench.py``)
against the JAX package's ``bench.py``, on the CPU (``--device cpu``, the
plain versions): its JSON line's keys, its packets and its trajectory
against the JAX ``Pipeline`` on the same packets, the fleet's sim runs
against ``main_batch``'s and its lanes against single pipelines and the
JAX ``BatchPipeline``, the
rescore rule, and no run without a card unless the CPU is asked for.

Tolerances (ROADMAP.md section C): the trajectory within 5 mm a scan of
JAX's, as ``tests/test_torch_sensors.py``'s mid360 test, and the raw ATE
within 5 mm; a fleet lane within 5e-4 m of a single pipeline (vmap's
batched products round otherwise) and within 5 mm of the JAX
``BatchPipeline``'s lane; the sim runs bit for bit.

On a card (marked ``cuda``, skipped without one): the runner's mid360 on
the card captures no graph in the measured span and prints the CPU run's
keys.  The card's host has no JAX, so this file imports it lazily:
``python -m pytest -p no:cacheprovider --noconftest -m cuda
tests/test_torch_bench.py``.
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch.tools import bench, scenarios
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

POS_TOL_M = 5e-3
LANE_TOL_M = 5e-4
SINGLE_S = 0.15  # mid360: 15 packets at 100 Hz
FLEET = "avia_batch2"
FLEET_S = 0.8

# bench.py's JSON line (bench.py:410-415 and 219-224)
TOP_KEYS = ["metric", "value", "unit", "vs_baseline", "extra"]
# bench.py:416-437, main()'s extra (the latency fields spliced in at :435)
SINGLE_EXTRA = ["scenario", "ate_rmse_m", "ate_definition", "ate_rmse_raw_m",
                "scans", "half1_scans_per_sec", "half2_scans_per_sec",
                "host_delta_p50_ms", "host_delta_p99_ms", "warm_s",
                "n_eff_last", "map_size", "platform", "knn_backend",
                "rescore", "tunnel_dispatch_ms"]
# bench.py:390-399 (bench.py:401's latency_skipped instead when the synced
# pass was skipped; on the CPU it runs)
LATENCY = ["latency_p50_ms", "latency_p99_ms", "latency_rtt_ms",
           "latency_rtt_p99_ms", "latency_corrected_p50_ms",
           "latency_corrected_p99_ms", "latency_budget_ms",
           "latency_budget_ok"]
# bench.py:225-229, main_batch()'s extra
BATCH_EXTRA = ["scenario", "aggregate_over_streams", "ate_rmse_m_per_stream",
               "scans", "platform"]
# the port's renames and additions
RENAMED = {"tunnel_dispatch_ms": "dispatch_ms"}
ADDED = ["card", "graphs_captured_in_span"]


def _port_keys(keys):
    return {RENAMED.get(k, k) for k in keys} | set(ADDED)


def _recording(cls, made: list):
    """A stand-in for ``cls`` that keeps every instance it builds."""
    def build(*args, **kwargs):
        made.append(cls(*args, **kwargs))
        return made[-1]
    return build


def _run_main(argv, record=()):
    """``bench.main(argv)`` with one torch thread; returns its JSON line,
    its stdout lines, and per name in ``record`` (classes the runner
    builds) the instances it built."""
    made = {name: [] for name in record}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp:
            for name in record:
                mp.setattr(bench, name,
                           _recording(getattr(bench, name), made[name]))
            with contextlib.redirect_stdout(out):
                assert bench.main(argv) == 0
    finally:
        torch.set_num_threads(n)
    lines = out.getvalue().splitlines()
    return json.loads(lines[-1]), lines, made


@pytest.fixture(scope="module")
def single():
    """The runner's mid360 on the CPU, its pipelines recorded."""
    return _run_main(["mid360", "--duration", str(SINGLE_S), "--device",
                      "cpu"], record=["Pipeline"])


@pytest.fixture(scope="module")
def fleet():
    """The runner's avia_batch2 on the CPU, its BatchPipeline recorded."""
    return _run_main([FLEET, "--duration", str(FLEET_S), "--device", "cpu"],
                     record=["BatchPipeline"])


def _jax():
    """The JAX package's sim and Pipeline (imported here: the card tests
    run where there is no JAX)."""
    from fast_lio_tpu import sim
    from fast_lio_tpu.pipeline import Pipeline
    return sim, Pipeline


def _jax_config(cfg):
    from fast_lio_tpu import config as jconfig
    return jconfig.Config(**{
        **dataclasses.asdict(cfg),
        "lidar_type": jconfig.LidarType(int(cfg.lidar_type)),
        "time_unit": jconfig.TimeUnit(int(cfg.time_unit))})


def _positions(traj):
    return np.stack([np.asarray(p, np.float64) for _, p, _ in traj])


@pytest.mark.parametrize("which", ["single", "fleet"])
def test_json_line_has_benchs_keys(which, request):
    got, lines, _ = request.getfixturevalue(which)
    assert len(lines) == 1 and list(got) == TOP_KEYS
    assert got["metric"] == "lio_scan_rate" and got["unit"] == "scans/s"
    # both rounded from the unrounded rate (bench.py:412-414)
    assert abs(got["vs_baseline"] - got["value"] / 100.0) <= 1e-3
    extra = got["extra"]
    if which == "single":
        assert set(extra) == _port_keys(SINGLE_EXTRA + LATENCY)
        assert extra["scenario"] == "mid360"
        assert extra["knn_backend"] == "plain" and extra["rescore"] is False
        assert extra["latency_budget_ms"] == 10.0
        assert len(extra["dispatch_ms"]) == 2
    else:
        assert set(extra) == _port_keys(BATCH_EXTRA)
        assert extra["scenario"] == FLEET
        assert extra["aggregate_over_streams"] == 2
        assert len(extra["ate_rmse_m_per_stream"]) == 2
    assert extra["platform"] == "cpu" and extra["card"] is None
    assert extra["graphs_captured_in_span"] == 0
    assert got["value"] > 0 and extra["scans"] > 0


def test_single_counts_the_packets_after_the_warm_ones(single):
    got, _, made = single
    cfg, data = scenarios.scenario("mid360", SINGLE_S)
    packets = bench.make_packets(cfg, data)
    extra = got["extra"]
    assert extra["scans"] == len(packets) - bench.N_WARM > 0
    assert extra["half1_scans_per_sec"] > 0
    assert extra["half2_scans_per_sec"] > 0
    # the measured pipeline, then the synced pass's fresh one, on every
    # packet each
    measured, synced = made["Pipeline"]
    assert len(measured.diags) == len(synced.diags) == len(
        measured.trajectory)


def test_single_run_matches_jax_on_the_same_packets(single):
    """The runner's mid360 trajectory against the JAX ``Pipeline`` fed
    bench.py's packets (bench.py:270-288) of the same run: every scan
    within 5 mm, and the raw ATE within 5 mm of JAX's."""
    jsim, JPipeline = _jax()
    got, _, made = single
    cfg, data = scenarios.scenario("mid360", SINGLE_S)
    jpipe = JPipeline(_jax_config(cfg))
    period = float(data.scan_stamps[1] - data.scan_stamps[0])
    imu_i, packets = 0, []
    for k in range(len(data.scans)):
        end = data.scan_stamps[k] + period
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= end + 1e-9:
            jpipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                           data.imu_gyr[imu_i])
            imu_i += 1
        jpipe.push_lidar(data.scan_stamps[k], data.scans[k],
                         data.scan_pt_times[k])
        while (pkt := jpipe.sync.pop_packet()) is not None:
            packets.append(pkt)
    assert len(packets) == got["extra"]["scans"] + bench.N_WARM
    for pkt in packets:
        jpipe.process_packet(pkt)
    want = jpipe.get_trajectory()
    traj = made["Pipeline"][0].get_trajectory()
    a, b = _positions(traj), _positions(want)
    assert a.shape == b.shape and len(a) >= bench.N_WARM
    np.testing.assert_allclose(a, b, rtol=0, atol=POS_TOL_M)
    assert abs(got["extra"]["ate_rmse_raw_m"]
               - jsim.ate_rmse(want, data)) <= POS_TOL_M


@pytest.mark.parametrize("n", [2, 8])
def test_batch_runs_are_main_batchs(n):
    """``scenarios.batch_runs(n)``, the runs of ``run_batch``, bit-equal
    to bench.py's ``main_batch(n)`` sims (bench.py:169-173; the JAX
    package's ``sim.generate``, numpy, no jit), at 0.3 s."""
    jsim, _ = _jax()
    got = scenarios.batch_runs(n, 0.3)
    assert len(got) == n
    for s, run in enumerate(got):
        want = jsim.generate(jsim.SimConfig(duration=0.3, n_rings=16,
                                            n_azimuth=400, seed=s))
        for f in dataclasses.fields(want):
            a, b = getattr(run, f.name), getattr(want, f.name)
            if isinstance(b, list):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(a, b)


def test_fleet_lanes_match_single_pipelines(fleet):
    """The fleet at bench.py's avia config (bench.py:168), each lane within
    5e-4 m of a single CPU ``Pipeline`` fed the same stream as bench.py
    feeds the fleet.  The streams carry the same data (the sim's seed draws
    only noise, and these runs have none), so one single run serves both."""
    _, _, made = fleet
    (bp,) = made["BatchPipeline"]
    assert bp.cfg == scenarios.config("avia") and bp.B == 2
    data, other = scenarios.batch_runs(2, FLEET_S)
    for x, y in zip(data.scans, other.scans):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(data.imu_acc, other.imu_acc)
    pipe = tpipe.Pipeline(bp.cfg, device="cpu")
    imu_i = 0
    for k in range(len(data.scans)):
        stamp = data.scan_stamps[k]
        while (imu_i < len(data.imu_t)
               and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9):
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while pipe.spin_once():
            pass
    want = _positions(pipe.get_trajectory())
    assert len(want) > bench.N_WARM
    for i in range(bp.B):
        got = _positions(bp.get_trajectory(i))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=LANE_TOL_M)


def test_fleet_lanes_match_jax_batch(fleet):
    """The runner's fleet against the JAX package's ``BatchPipeline`` at
    bench.py's avia config on the same ``batch_runs``, fed round by round
    as ``main_batch`` feeds it (bench.py:180-211; its timing left out):
    each lane's stamps equal and its positions within 5 mm of JAX's lane
    (``tests/test_torch_batch.py``'s tolerance for the two batches)."""
    from fast_lio_tpu.batch import BatchPipeline as JBatchPipeline

    _, _, made = fleet
    (bp,) = made["BatchPipeline"]
    datas = scenarios.batch_runs(bp.B, FLEET_S)
    jbp = JBatchPipeline(_jax_config(bp.cfg), bp.B)
    imu_i = [0] * bp.B
    for k in range(max(len(d.scans) for d in datas)):
        for i, d in enumerate(datas):
            if k >= len(d.scans):
                jbp.mark_done(i)
                continue
            stamp = d.scan_stamps[k]
            while (imu_i[i] < len(d.imu_t)
                   and d.imu_t[imu_i[i]] <= stamp + 0.1 + 1e-9):
                jbp.push_imu(i, d.imu_t[imu_i[i]], d.imu_acc[imu_i[i]],
                             d.imu_gyr[imu_i[i]])
                imu_i[i] += 1
            jbp.push_lidar(i, stamp, d.scans[k], d.scan_pt_times[k])
        while jbp.spin_once():
            pass
    for i in range(bp.B):
        got, want = bp.get_trajectory(i), jbp.get_trajectory(i)
        assert len(want) > bench.N_WARM
        assert [t for t, _, _ in got] == [t for t, _, _ in want]
        np.testing.assert_allclose(_positions(got), _positions(want),
                                   rtol=0, atol=POS_TOL_M)


def test_rescore_ab_follows_benchs_rule(capsys):
    """``FAST_LIO_RESCORE=1`` (bench.py:252-266): on for avia, refused
    with bench.py's message where the wide fallback runs (mid360), and
    refused on the card, where the rescore's plain candidate block would
    stand against the kernel on the other side of the A/B."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    avia, mid360 = scenarios.config("avia"), scenarios.config("mid360")
    assert bench.configure("avia", avia, cpu, {}) == avia
    on = bench.configure("avia", avia, cpu, {"FAST_LIO_RESCORE": "1"})
    assert on == dataclasses.replace(avia, rescore_research=True)
    assert bench.knn_backend(on, cpu) == "plain_candidates"
    assert capsys.readouterr().err == ""
    assert bench.configure("mid360", mid360, cpu,
                           {"FAST_LIO_RESCORE": "1"}) == mid360
    assert capsys.readouterr().err.startswith(
        "FAST_LIO_RESCORE=1 ignored: scenario 'mid360' uses "
        "knn_wide_fallback")
    assert bench.configure("avia", avia, cuda,
                           {"FAST_LIO_RESCORE": "1"}) == avia
    assert capsys.readouterr().err.startswith(
        "FAST_LIO_RESCORE=1 ignored on the card")
    assert bench.knn_backend(avia, cuda) == "cuda_per_query"
    assert bench.knn_backend(mid360, cuda) == "cuda_per_query"


def test_measures_nothing_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("has a CUDA device")
    assert bench.main(["mid360"]) == 1
    assert bench.main([FLEET]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert captured.err.count("no CUDA device") == 2
    with pytest.raises(SystemExit):
        bench.main(["kitti", "--device", "cpu"])


@pytest.mark.cuda
def test_cuda_runner_captures_nothing_in_the_span(single):
    """The runner's mid360 at 0.4 s on the card: no CUDA graph captured in
    the measured span, the per-query kernel, and the CPU run's keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got, lines, _ = _run_main(["mid360", "--duration", "0.4"])
    cpu = single[0]
    assert len(lines) == 1 and list(got) == list(cpu)
    assert set(got["extra"]) == set(cpu["extra"])
    extra = got["extra"]
    assert extra["graphs_captured_in_span"] == 0
    assert extra["platform"] == "gpu" and extra["card"]
    assert extra["knn_backend"] == "cuda_per_query"
    assert extra["scans"] == 40 - bench.N_WARM

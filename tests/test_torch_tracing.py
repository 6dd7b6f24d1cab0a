"""The port's tracer (``fast_lio_tpu_torch/tracing.py``) and the readers of
its spans, counters and stage stamps (``liobench/program_trace.py``).

On the CPU: off, a run records nothing and loads nothing; on, the spans of a
scan nest under its ``process_packet`` and share its index, the counters
count, the eager step's eight host-clock stamps are monotone and inside the
scan's span, a tiny traced cell carries the dumps and its readers return a
value or None as documented.  On a card (marked ``cuda``): the stamp kernel
in a captured graph, the outputs with the tracer on and off bit for bit, and
the stamps on the profiler's clock.
"""
import collections
import dataclasses
import json
import sys
import warnings

import numpy as np
import pytest
import torch

from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch import sim as tsim
from fast_lio_tpu_torch import tracing
from fast_lio_tpu_torch.kernels import build
from fast_lio_tpu_torch.kernels import counts as tcounts
from fast_lio_tpu_torch.preprocess import drivers
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(lidar_type=tcfg.LidarType.AVIA, det_range=450.0,
             n_points_max=2048, n_ds_max=1024, map_h_log2=12,
             point_filter_num=1)


@pytest.fixture(autouse=True)
def fresh_tracer(monkeypatch):
    """The tracer's process-wide state, fresh for each test (a graph's
    stamp buffers, ``_buffers``, stay for the process)."""
    fresh = dict(ON=False, _device=None, _spans=[], _open=[], _ranges={},
                 _scan=0, _captured_off=False, _warned=False, _ring=None,
                 _count=None, _clock=None, _cpu_steps=0, _read=0,
                 _calib=None, counters=collections.Counter())
    for name, value in fresh.items():
        monkeypatch.setattr(tracing, name, value)
    yield
    tracing.disable()


def _avia_msg(pts, times):
    """A Livox CustomMsg's fields for a sim scan (every point on line 0)."""
    n = len(pts)
    return dict(xyz=pts, reflectivity=np.zeros(n, np.float32),
                offset_time_ns=(np.asarray(times) * 1e9).astype(np.int64),
                tag=np.full(n, 0x10, np.uint8), line=np.zeros(n, np.uint8))


def _feed(pipe, data, cfg=None):
    """A sim run through the packet API; with ``cfg``, each scan as a
    Livox message through ``drivers.decode`` first."""
    imu_i = 0
    for k in range(len(data.scans)):
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and \
                data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        if cfg is None:
            pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        else:
            scan = drivers.decode(
                _avia_msg(data.scans[k], data.scan_pt_times[k]), cfg)
            pipe.push_lidar(stamp, scan.pts, scan.time_offset_s,
                            scan.intensity)
        while pipe.spin_once():
            pass


def _small_run():
    data = tsim.generate(tsim.SimConfig(duration=1.0, n_rings=8,
                                        n_azimuth=200, range_noise=0.01))
    return tcfg.Config(**SMALL), data


def test_off_records_nothing_and_loads_nothing(monkeypatch):
    loaded = []
    monkeypatch.setattr(build, "load", lambda name: loaded.append(name))
    cfg, data = _small_run()
    before = tcounts.snapshot()
    pipe = tpipe.Pipeline(cfg, device="cpu")
    _feed(pipe, data, cfg)
    assert len(pipe.diags) >= 5 and all(d.total_time > 0 for d in pipe.diags)
    assert tcounts.total(tcounts.since(before)) == 0
    d = tracing.dump()
    assert d["spans"] == [] and d["stamps"] is None and d["device"] is None
    assert tracing._ring is None and tracing._spans == []
    assert loaded == [] and tracing._lib.cache_info().currsize == 0


def test_spans_nest_under_process_packet_with_shared_scan_index():
    cfg, data = _small_run()
    tracing.enable("cpu")
    before = tcounts.snapshot()
    pipe = tpipe.Pipeline(cfg, device="cpu")
    _feed(pipe, data, cfg)
    assert tcounts.total(tcounts.since(before)) == 0  # stamps launch nothing
    spans = tracing.dump()["spans"]
    roots = [s for s in spans if s["name"] == "process_packet"]
    assert [r["scan"] for r in roots] == list(range(len(roots)))
    init = len(roots) - len(pipe.diags)  # the scans of the IMU's init
    assert init >= 1 and len(pipe.diags) >= 5
    for s in spans:
        assert s["start"] <= s["end"]
        if s["name"] in ("decode", "sync", "process_packet"):
            assert s["parent"] is None
        else:
            p = spans[s["parent"]]
            assert p["name"] == "process_packet" and p["scan"] == s["scan"]
            assert p["start"] <= s["start"] and s["end"] <= p["end"]
    by_scan = collections.defaultdict(list)
    for s in spans:
        by_scan[s["scan"]].append(s["name"])
    assert by_scan[0][:4] == ["decode", "sync", "process_packet", "imu_init"]
    for k in range(1, len(roots)):
        names = by_scan[k]
        assert names.index("decode") < names.index("process_packet")
        assert ("imu_init" in names) == (k < init)
        assert ("pack" in names) == (k >= init)
    # StepDiag.total_time is the root span's pair of clock reads
    for r, d in zip(roots[init:], pipe.diags):
        assert d.total_time == (r["end"] - r["start"]) * 1e-9


def test_cpu_stamps_are_monotone_and_inside_the_scan():
    cfg, data = _small_run()
    tracing.enable("cpu")
    pipe = tpipe.Pipeline(cfg, device="cpu")
    _feed(pipe, data)
    d = tracing.dump()
    st = d["stamps"]
    roots = [s for s in d["spans"] if s["name"] == "process_packet"]
    roots = roots[len(roots) - len(pipe.diags):]  # after the IMU's init
    t = np.asarray(st["t"])
    assert t.shape == (len(pipe.diags), tracing.STAMPS) and st["lost"] == 0
    assert (np.diff(t, axis=1) >= 0).all() and (np.diff(t[:, 0]) > 0).all()
    regions = np.diff(t, axis=1)
    assert regions.shape[1] == len(tracing.REGIONS)
    assert (regions.sum(axis=1) == t[:, -1] - t[:, 0]).all()
    for row, r in zip(t, roots):  # each step inside its scan's span
        assert r["start"] <= row[0] and row[-1] <= r["end"]
    assert st["calibration"]["offset_ns"] == 0  # the host's own clock
    again = tracing.dump()["stamps"]
    assert again["t"] == [] and again["first"] == st["first"] + len(t)


def test_cpu_ring_counts_the_rows_it_loses():
    tracing.enable("cpu", rows=4)
    for _ in range(10):
        for k in range(tracing.STAMPS):
            tracing.stamp(k)
    st = tracing.dump()["stamps"]
    assert (st["first"], st["lost"], len(st["t"])) == (6, 6, 4)
    assert (np.diff(np.asarray(st["t"]).ravel()) >= 0).all()


def test_counters_count_builds_and_build_spans(monkeypatch, tmp_path):
    """``kernel_builds`` counts each ``nvcc`` run (a stand-in compiler that
    writes an empty library here) and a ``build`` span says whether the
    load compiled."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "a = sys.argv\nopen(a[a.index('-o') + 1], 'wb').close()\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    tracing.enable("cpu")
    build.build_all(["probe"])
    build.build_all(["probe"])
    assert tracing.counters["kernel_builds"] == 1
    with pytest.raises(OSError):  # an empty file is no library
        build.load("probe")
    d = tracing.dump()
    assert [(s["name"], s["lib"], s["compiled"]) for s in d["spans"]] == [
        ("build", "probe", False)]
    assert d["counters"] == {"kernel_builds": 1}


def test_spans_are_profiler_ranges_and_enabling_late_warns():
    cfg, data = _small_run()
    tracing.note_capture()  # a step captured with the tracer off
    with pytest.warns(UserWarning, match="no stage stamps"):
        tracing.enable("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tracing.enable("cpu")  # once
    pipe = tpipe.Pipeline(cfg, device="cpu")
    from torch.profiler import ProfilerActivity, profile
    first = dataclasses.replace(data, scans=data.scans[:1])  # the IMU init
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _feed(pipe, first)
    names = {e.name for e in prof.events()}
    assert {"fast_lio.process_packet", "fast_lio.imu_init",
            "fast_lio.sync"} <= names


# ---------------------------------------------------------------------------
# the readers of a traced cell
# ---------------------------------------------------------------------------


def _card_run(rows, spans=(), before=None, after=None, scans=None):
    """A ``program_trace.Run`` of a replay on a card, from stamp rows (ns)."""
    from liobench import program_trace as pt
    dump = lambda t, sp, ln: dict(  # noqa: E731
        device="cuda:0", spans=list(sp), counters={}, launches=ln,
        stamps=dict(t=t, lost=0, first=0, calibration={}))
    none = {n: {} for n in tcounts.NAMES}
    run = pt.Run(kind="replay",
                 setup=dump([], [dict(name="capture", start=0,
                                      end=2_500_000_000)], none),
                 before=dump([], [], before or none),
                 window=dump(rows, spans, after or none),
                 numbers=dict(scans=scans or len(rows), wall_s=1.0))
    return run


def test_readers_read_the_stamps_as_documented():
    from liobench import program_trace as pt
    # two replays: regions 1..7 ms and 2..8 ms; 3 ms between them
    r0 = np.cumsum([0] + [k * 1_000_000 for k in range(1, 8)])
    r1 = r0[-1] + 3_000_000 + np.cumsum([0] + [k * 1_000_000
                                               for k in range(2, 9)])
    spans = [dict(name="pack", start=0, end=400_000, parent=None, scan=0),
             dict(name="feed_wait", start=int(r0[-1]) - 10,
                  end=int(r1[0]) - 10, parent=None, scan=1)]
    knn = {n: {} for n in tcounts.NAMES}
    after = dict(knn, knn={8: 10, 27: 4})
    run = _card_run([r0.tolist(), r1.tolist()], spans,
                    before=dict(knn, knn={8: 2}), after=after, scans=2)
    got = {n: read(run) for n, (_u, read) in pt.METRICS.items()}
    assert got["graph_ms.replay"] == pytest.approx(0.5 * (28 + 35))
    assert got["graph_gap_ms.replay"] == pytest.approx(3.0)
    assert got["imu_ms.replay"] == pytest.approx(2.5)
    assert got["map_ms.replay"] == pytest.approx(0.5 * (3 + 6 + 4 + 7))
    assert got["downsample_ms.replay"] == pytest.approx(4.5)
    assert got["update_ms.replay"] == pytest.approx(5.5)
    assert got["pack_ms.replay"] == pytest.approx(0.4)
    assert got["knn_searches_per_scan.replay"] == pytest.approx(6.0)
    assert got["capture_s"] == pytest.approx(2.5)
    assert got["launch_ms.replay"] is None and got["graph_ms.online"] is None
    assert pt.gaps_by_span(run) == {"feed_wait": pytest.approx(3e-3)}


def test_tiny_traced_cell_carries_the_program_trace():
    """A cell at a tiny size on the CPU with the tracer on (the harness's
    profiled windows left out): the dumps are kept, the host spans' readers
    give values, the stamps' and the launch counters' give None (no card),
    and the result is still correct."""
    from liobench import program_trace as pt
    from liobench.tests.tiny import SECONDS, TINY
    out, run = pt.run_traced("avia.replay", 20251018, SECONDS, False, True,
                             "cpu", overrides=TINY)
    assert out["correct"] and not tracing.ON
    assert run.kind == "replay" and run.numbers["scans"] > 0
    assert run.window["device"] == "cpu"
    assert len(run.window["stamps"]["t"]) == run.numbers["scans"]
    names = {s["name"] for s in run.window["spans"]}
    assert {"decode", "sync", "process_packet", "pack"} <= names
    s = pt.summary(run)
    assert set(s["program_metrics"]) == {"pack_ms.replay"}
    assert s["program_metrics"]["pack_ms.replay"]["value"] > 0
    assert s["consistency"]["window_stamped"] == run.numbers["scans"]
    json.dumps(s)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stamps are a CUDA kernel")


@pytest.mark.cuda
def test_cuda_stamps_in_a_captured_graph_increase_and_count_wraps():
    _card()
    tracing.enable("cuda", rows=4)
    x = torch.zeros(1 << 20, device="cuda")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for k in range(tracing.STAMPS):
            tracing.stamp(k)
            x.add_(1.0)
    tracing.dump()
    for _ in range(10):
        graph.replay()
    torch.cuda.synchronize()
    st = tracing.dump()["stamps"]
    t = np.asarray(st["t"])
    assert (st["lost"], len(t)) == (6, 4)
    assert (np.diff(t.ravel()) > 0).all()
    assert st["calibration"]["error_ns"] <= 50_000


def _avia_scans():
    cfg = tcfg.PRESETS["avia"]
    return cfg, tsim.generate(tsim.SimConfig(duration=10.6, n_rings=32,
                                             n_azimuth=400))


@pytest.mark.cuda
def test_cuda_outputs_bit_identical_with_the_tracer_on_and_off():
    """Over 100 captured avia scans: poses, state, covariance and map bit
    for bit with the tracer off and on, the same launches a replay, and a
    row of stamps each step."""
    _card()
    cfg, data = _avia_scans()
    runs = []
    for on in (False, True):
        if on:
            with pytest.warns(UserWarning, match="no stage stamps"):
                tracing.enable("cuda")  # the first run's graph has none
        pipe = tpipe.Pipeline(cfg)
        _feed(pipe, data)
        torch.cuda.synchronize()
        runs.append(pipe)
    off, on = runs
    assert len(off.diags) >= 100
    assert np.array_equal(np.stack([p for _, p, _ in off.get_trajectory()]),
                          np.stack([p for _, p, _ in on.get_trajectory()]))
    for a, b in zip((*off.x, off.P, off.map.packed, off.map.dropped),
                    (*on.x, on.P, on.map.packed, on.map.dropped)):
        assert torch.equal(a, b)
    assert ([s["launches_per_replay"] for s in off.graphs.stats().values()]
            == [s["launches_per_replay"] for s in on.graphs.stats().values()])
    d = tracing.dump()
    assert len(d["stamps"]["t"]) == len(on.diags)
    caps = [s for s in d["spans"] if s["name"] == "capture"]
    assert [(s["end"] - s["start"]) * 1e-9 for s in caps] == [
        s["capture_s"] for s in on.graphs.stats().values()]


@pytest.mark.cuda
def test_cuda_stamps_on_the_profilers_clock():
    """In a profiled window of captured scans the spans are ``fast_lio.*``
    ranges, and each stamp kernel's activity starts within the
    calibration's error (and the timer's microsecond) of its stamp mapped
    onto the trace's clock."""
    _card()
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # a session before the first capture
        torch.cuda.synchronize()
    cfg, data = _avia_scans()
    tracing.enable("cuda")
    pipe = tpipe.Pipeline(cfg)
    head = 12

    def cut(a, b):
        return dataclasses.replace(data, scans=data.scans[a:b],
                                   scan_stamps=data.scan_stamps[a:b],
                                   scan_pt_times=data.scan_pt_times[a:b])
    _feed(pipe, cut(0, head))
    torch.cuda.synchronize()
    tracing.dump()
    keep = data.imu_t > data.scan_stamps[head - 1] + 0.1 + 1e-9
    rest = dataclasses.replace(cut(head, head + 5), imu_t=data.imu_t[keep],
                               imu_acc=data.imu_acc[keep],
                               imu_gyr=data.imu_gyr[keep])
    with profile(activities=acts) as prof:
        _feed(pipe, rest)
        torch.cuda.synchronize()
    d = tracing.dump()
    names = {e.name for e in prof.events()}
    assert {"fast_lio.process_packet", "fast_lio.launch"} <= names
    start = prof.profiler.kineto_results.trace_start_ns()
    kernels = sorted(start + 1000 * e.time_range.start for e in prof.events()
                     if "stamp_kernel" in e.name and
                     e.device_type == torch.autograd.DeviceType.CUDA)
    stamps = np.asarray(d["stamps"]["t"]).ravel()
    assert len(kernels) == len(stamps) > 0
    err = max(d["stamps"]["calibration"]["error_ns"],
              d["stamps"]["calibration"]["previous_error_ns"])
    assert err <= 50_000
    diff = stamps - np.asarray(kernels)
    assert np.abs(diff).max() <= err + 2_000, (err, diff.min(), diff.max())

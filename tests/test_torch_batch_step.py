"""The port's batched step (``BatchPipeline``: ``torch.func.vmap`` over the
single-stream ``packed_step``) against the JAX package's vmapped step and
``BatchPipeline``, and against B single port ``Pipeline``s, on the CPU
(the plain kNN search per stream, through the custom op's vmap rule).

Tolerances, each with its reason:

* one batched step from the same state and buffers as one JAX vmapped step
  (``convert.load_numpy_batch_state``): float32 state within STEP_ATOL
  (5e-5, the measurement-model tolerance of ROADMAP.md section C, the
  widest of the step's parts) and P within STEP_P_RTOL relative to its
  largest entry (1e-4, the IMU tolerance there); on a CPU the round tested
  measured 9.5e-7 and 1.9e-6 (every round of the run: at most 1.6e-6 and
  8.9e-5); float64 within 1e-8 (measured 2e-15 and 9e-13);
* the batch against B single ``Pipeline``s on the same packets: under vmap
  the step's matrix-vector products run as batched matrix products, which
  round differently, so not bit for bit; within BATCH_VS_SINGLE_M
  (measured 8.0e-5 m);
* the shared pad, the truncation counts and the no-op lane's finiteness
  are exact; the no-op lane's finite values within the float32 tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fast_lio_tpu_torch import batch as tbatch
from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import convert
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch.batch import BatchPipeline
from fast_lio_tpu_torch.kernels import counts, graph_if
from fast_lio_tpu_torch.kernels import knn as tknn
from fast_lio_tpu_torch.step_graph import StepGraphs
from test_torch_batch import KW, _feed_batch, _feed_single, _positions
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEP_ATOL = 5e-5
STEP_P_RTOL = 1e-4
F64_TOL = 1e-8
BATCH_VS_SINGLE_M = 5e-4


def _gen(seed, duration, n_azimuth=120):
    from fast_lio_tpu import sim as simlib

    return simlib.generate(simlib.SimConfig(
        duration=duration, n_rings=8, n_azimuth=n_azimuth, range_noise=0.005,
        seed=seed))


def _configs(**kw):
    from fast_lio_tpu.config import Config as JConfig
    from fast_lio_tpu.config import LidarType as JLidarType

    args = dict(KW, **kw)
    return (JConfig(lidar_type=JLidarType.AVIA, **args),
            tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **args))


def _jax_batch(jcfg, n, record=False):
    """A JAX BatchPipeline whose vmapped step keeps, per round, its inputs
    and outputs as numpy (with ``record``) and the buffer's shape."""
    import jax

    from fast_lio_tpu.batch import BatchPipeline as JBatchPipeline

    jbp = JBatchPipeline(jcfg, n)
    jbp.rounds_in, jbp.rounds_out, jbp.shapes = [], [], []
    step = jbp._step_fn

    def keep(x, P, m, carry, Q, buf, lo, hi, init):
        jbp.shapes.append(tuple(buf.shape))
        if record:
            jbp.rounds_in.append(dict(
                jax.device_get(dict(x=x, P=P, m=m, carry=carry, buf=buf,
                                    lm=(lo, hi, init))),
                host={k: list(getattr(jbp, k)) for k in convert.HOST_SCALARS}))
        out = step(x, P, m, carry, Q, buf, lo, hi, init)
        if record:
            jbp.rounds_out.append(jax.device_get(out[:2]))
        return out

    jbp._step_fn = keep
    return jbp


def _port_shapes(bp):
    """Wraps ``bp._run_round`` to keep each round's (B, L)."""
    bp.shapes = []
    run = bp._run_round

    def keep(bufs):
        bp.shapes.append(tuple(bufs.shape))
        return run(bufs)

    bp._run_round = keep
    return bp


def _arrays(rec):
    """A recorded JAX round's state in ``convert.KEYS``' layout."""
    x, m, carry, lm = rec["x"], rec["m"], rec["carry"], rec["lm"]
    arrays = {f: np.asarray(getattr(x, f)) for f in convert.STATE_FIELDS}
    arrays.update(P=rec["P"], map_packed=m.packed, map_dropped=m.dropped,
                  angvel_last=carry.angvel_last, acc_s_last=carry.acc_s_last,
                  lm_lo=lm[0], lm_hi=lm[1], lm_init=lm[2], **rec["host"])
    return arrays


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_one_batched_step_matches_the_jax_vmapped_step(dtype):
    """(b) The JAX batch runs a few rounds; the state before a round, loaded
    through ``convert.load_numpy_batch_state``, and that round's packed
    buffer go through one port batched step; each lane's state, P and
    counts against the JAX step's."""
    jcfg, tcfg_ = _configs(compute_dtype=dtype)
    datas = [_gen(0, 1.0), _gen(1, 1.0), _gen(2, 1.0)]
    jbp = _jax_batch(jcfg, 3, record=True)
    _feed_batch(jbp, datas)
    k = 4  # a round with a map and the update on
    rec, (jx, jP) = jbp.rounds_in[k], jbp.rounds_out[k]
    bp = BatchPipeline(tcfg_, 3, device="cpu")
    convert.load_numpy_batch_state(bp, _arrays(rec))
    np.testing.assert_array_equal(bp.map.packed.numpy(), rec["m"].packed)
    buf = torch.from_numpy(np.array(rec["buf"], np.float32))
    out = bp._batched_step(buf)
    atol = STEP_ATOL if dtype == "float32" else F64_TOL
    p_rtol = STEP_P_RTOL if dtype == "float32" else F64_TOL
    for i in range(3):
        for f in convert.STATE_FIELDS:
            np.testing.assert_allclose(getattr(bp.x, f)[i].numpy(),
                                       np.asarray(getattr(jx, f))[i],
                                       rtol=0, atol=atol, err_msg=f)
        scale = np.abs(jP[i]).max()
        np.testing.assert_allclose(bp.P[i].numpy(), jP[i], rtol=0,
                                   atol=p_rtol * scale)
    assert out["pose"].shape == (3, 7) and out["diag"].shape == (3, 4)
    assert (out["diag"][:, 1] > 0).all()  # every lane found planes
    with pytest.raises(KeyError):
        convert.load_numpy_batch_state(
            bp, {k: v for k, v in _arrays(rec).items() if k != "P"})


def test_batch_matches_single_pipelines_lane_by_lane():
    """(c) Three streams of different lengths against three single CPU
    Pipelines on the same packets: poses within BATCH_VS_SINGLE_M, the same
    iteration counts."""
    datas = [_gen(0, 1.2), _gen(1, 0.9), _gen(2, 1.0)]
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **KW)
    singles = [_feed_single(tpipe.Pipeline(cfg, device="cpu"), d)
               for d in datas]
    bp = BatchPipeline(cfg, 3, device="cpu")
    rounds = _feed_batch(bp, datas)
    assert bp.rounds == rounds
    for i in range(3):
        traj, single = bp.get_trajectory(i), singles[i].get_trajectory()
        assert [t for t, _, _ in traj] == [t for t, _, _ in single]
        np.testing.assert_allclose(_positions(traj), _positions(single),
                                   rtol=0, atol=BATCH_VS_SINGLE_M)
        assert [d.iterations for d in bp.get_diags(i)] == [
            int(d.iterations) for d in singles[i].diags]
        assert [d.map_size for d in bp.get_diags(i)] == [
            int(d.map_size) for d in singles[i].diags]
    # the device-side trajectory holds the same poses
    pos, quat = bp.trajectory[0][-1][1:]
    assert pos.shape == (3,) and quat.shape == (4,)
    np.testing.assert_array_equal(pos.numpy(), bp.get_trajectory(0)[-1][1])


def test_round_shares_one_pad_and_counts_truncation_as_jax():
    """(d) Pad buckets (256, 512): stream 0's scans (about 960 points) need
    the largest and are truncated, stream 1's (about 240) fit the smallest
    alone; every round is padded to what its packets need together, as in
    the JAX package, and each stream's truncation is counted as there."""
    kw = dict(n_points_max=512, pad_buckets=(256, 512))
    jcfg, tcfg_ = _configs(**kw)
    datas = [_gen(0, 0.8), _gen(1, 0.6, n_azimuth=30)]
    jbp = _jax_batch(jcfg, 2)
    with pytest.warns(UserWarning, match="truncated|dropped"):
        _feed_batch(jbp, datas)
    bp = _port_shapes(BatchPipeline(tcfg_, 2, device="cpu"))
    with pytest.warns(UserWarning, match="dropped"):
        _feed_batch(bp, datas)
    M = tcfg_.n_imu_max
    assert bp.shapes == jbp.shapes
    assert {L for _, L in bp.shapes} == {8 + 7 * M + 5 * 512}
    assert bp.truncated_points == list(jbp.truncated_points)
    assert bp.truncated_points[0] > 0 and bp.truncated_points[1] == 0
    assert sum(d.n_truncated for d in bp.get_diags(0)) == bp.truncated_points[0]
    # stream 1 alone in its rounds: the small bucket
    solo = _port_shapes(BatchPipeline(tcfg_, 1, device="cpu"))
    _feed_batch(solo, datas[1:])
    assert {L for _, L in solo.shapes} == {8 + 7 * M + 5 * 256}


def test_ended_stream_lane_is_left_as_jax_leaves_it():
    """(e) Stream 1 ends two rounds before stream 0: its lane runs the JAX
    package's no-op packet (no point, no IMU sample, no update).  The JAX
    step's final predict to scan end then has dt = +inf (no IMU sample to
    end at), so the lane's state becomes non-finite there; the port leaves
    it so too, value for value where finite.  Nothing of the lane is
    recorded after its end."""
    jcfg, tcfg_ = _configs()
    datas = [_gen(0, 1.0), _gen(1, 0.8)]
    jbp = _jax_batch(jcfg, 2)
    _feed_batch(jbp, datas)
    bp = BatchPipeline(tcfg_, 2, device="cpu")
    rounds = _feed_batch(bp, datas)
    n1 = len(bp.get_trajectory(1))
    assert n1 == len(jbp.get_trajectory(1)) < rounds == len(
        bp.get_trajectory(0))
    for name, port, jax_ in [(f, getattr(bp.x, f)[1].numpy(),
                              np.asarray(getattr(jbp.x, f))[1])
                             for f in convert.STATE_FIELDS] + [
            ("P", bp.P[1].numpy(), np.asarray(jbp.P)[1])]:
        np.testing.assert_array_equal(np.isfinite(port), np.isfinite(jax_),
                                      err_msg=name)
        ok = np.isfinite(jax_)
        np.testing.assert_allclose(port[ok], jax_[ok], rtol=1e-4,
                                   atol=STEP_ATOL, err_msg=name)
    assert not np.isfinite(bp.x.pos[1].numpy()).all()
    assert np.isfinite(bp.x.pos[0].numpy()).all()
    assert len(bp.get_diags(1)) == n1


def test_batched_step_runs_with_the_vmap_fallback_off(monkeypatch):
    """(f) The step runs with vmap's per-example fallback disabled (and puts
    it back after), so an op with no batching rule raises instead of
    looping over the lanes."""
    seen = []
    step = tbatch.packed_step

    def spy(*args):
        seen.append(torch._C._functorch._is_vmap_fallback_enabled())
        return step(*args)

    monkeypatch.setattr(tbatch, "packed_step", spy)
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **KW)
    bp = BatchPipeline(cfg, 2, device="cpu")
    _feed_batch(bp, [_gen(0, 0.6), _gen(1, 0.6)])
    assert seen and not any(seen)
    assert torch._C._functorch._is_vmap_fallback_enabled()

    def unbatchable(*args):
        out = step(*args)
        # in-place scatter of a scalar: no batching rule
        out[0].pos.clone().scatter_(0, torch.zeros(1, dtype=torch.long), 0.0)
        return out

    monkeypatch.setattr(tbatch, "packed_step", unbatchable)
    bp = BatchPipeline(cfg, 2, device="cpu")
    with pytest.raises(RuntimeError, match="fallback"):
        _feed_batch(bp, [_gen(0, 0.6), _gen(1, 0.6)])
    assert torch._C._functorch._is_vmap_fallback_enabled()


def test_batch_refuses_the_grouped_backend():
    """(g) The grouped kernels have no stream axis, and the JAX batch has no
    grouped backend."""
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, knn_backend="grouped",
                      **KW)
    with pytest.raises(ValueError, match="grouped"):
        BatchPipeline(cfg, 2, device="cpu")


def test_batch_defaults_to_cuda(monkeypatch):
    """(h) ``BatchPipeline()`` means CUDA, and raises without it unless the
    caller asks for the CPU, which runs the step eagerly."""
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **KW)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchPipeline(cfg, 2)
    bp = BatchPipeline(cfg, 2, device="cpu")
    assert bp.graphs is None and bp.feed is None
    assert bp.map.rows.shape == (2, 2**12 + 1, 4 * 64)
    assert bp.map.packed.data_ptr() == bp.map.rows.data_ptr()


def test_rescore_research_runs_batched():
    """``rescore_research`` (its plain candidate re-rank) runs under vmap
    too: each lane within BATCH_VS_SINGLE_M of its single run."""
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, rescore_research=True,
                      **KW)
    datas = [_gen(0, 0.8), _gen(1, 0.8)]
    singles = [_feed_single(tpipe.Pipeline(cfg, device="cpu"), d)
               for d in datas]
    bp = BatchPipeline(cfg, 2, device="cpu")
    _feed_batch(bp, datas)
    for i in range(2):
        np.testing.assert_allclose(_positions(bp.get_trajectory(i)),
                                   _positions(singles[i].get_trajectory()),
                                   rtol=0, atol=BATCH_VS_SINGLE_M)


def test_batch_with_the_wide_fallback_launches_nothing_on_cpu():
    """The wide fallback's two searches a pass run batched; on CPU tensors
    the custom op runs the plain version (no kernel launch counted)."""
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, knn_wide_fallback=True,
                      knn_wide_max_queries=64, **KW)
    counters = (tknn.launches, tknn.launches_f64, tknn.batched_launches,
                tknn.batched_launches_f64)
    before = [dict(c) for c in counters]
    bp = BatchPipeline(cfg, 2, device="cpu")
    _feed_batch(bp, [_gen(0, 0.6), _gen(1, 0.6)])
    assert bp.rounds > 0
    assert [dict(c) for c in counters] == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the batched step's kNN kernel has "
                    "no CPU mode")


def _card_run(n_streams, duration=1.6):
    from fast_lio_tpu_torch import sim as tsim

    cfg = tcfg.PRESETS["avia"]
    # range noise, so that each seed's stream differs
    datas = [tsim.generate(tsim.SimConfig(duration=duration, n_rings=32,
                                          n_azimuth=400, range_noise=0.01,
                                          seed=s))
             for s in range(n_streams)]
    return cfg, datas


@pytest.mark.cuda
def test_cuda_captured_batch_matches_captured_single_pipelines():
    """The captured batched step (AVIA preset, B = 3, stream 2 shorter)
    against three single captured Pipelines on the card: 5 mm per scan,
    one graph for the fleet, one batched kNN launch a search, and the
    passes a round (counted on the device) those of JAX's batched
    ``while_loop``."""
    _card()
    cfg, datas = _card_run(3)
    datas[2] = dataclasses.replace(datas[2], scans=datas[2].scans[:10],
                                   scan_stamps=datas[2].scan_stamps[:10])
    singles = [_feed_single(tpipe.Pipeline(cfg), d) for d in datas]
    bp = BatchPipeline(cfg, 3)
    counts.settle()
    before = (tknn.launches[8], tknn.batched_launches[8],
              graph_if.while_launches[0], graph_if.while_launches[1])
    rounds = _feed_batch(bp, datas)
    counts.settle()
    stats = bp.graphs.stats()
    assert len(stats) == 1 and all(s["replays"] > 0 and s["gated"]
                                   for s in stats.values())
    n_pass = cfg.max_iteration + 1
    # outside any conditional node a replay launches the WHILE node's
    # condition kernel (once, before the node) and the downsample's
    # batched segment_sum kernel
    (st,) = stats.values()
    assert st["launches_per_replay"] == 2
    assert graph_if.while_launches[0] - before[2] == st["replays"]
    # every pass runs one batched R = 8 search (under vmap the re-search
    # is a select), inside the WHILE node, counted on the device only as
    # the node runs it: the passes run.  JAX's batched while_loop runs the
    # most any lane ran, and every pass in a round with a lane that does
    # not update (the first round, whose eager step runs them all, and
    # the ended stream's no-op lane)
    iters = np.zeros((rounds, 3), np.int64)
    for i in range(3):
        its = [d.iterations for d in bp.get_diags(i)]
        iters[:len(its), i] = its
    want = np.where(iters.min(axis=1) > 0, iters.max(axis=1), n_pass)
    searches = tknn.batched_launches[8] - before[1]
    assert searches == want.sum()
    assert rounds <= searches < rounds * n_pass  # an early exit
    # the condition kernel counted the replays' passes (the first round
    # of the bucket ran eagerly, every pass masked)
    passes = graph_if.while_launches[1] - before[3]
    assert passes == searches - n_pass * len(stats)
    assert tknn.launches[8] == before[0]  # no single launch
    for i in range(3):
        got = _positions(bp.get_trajectory(i))
        want = _positions(singles[i].get_trajectory())
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 5e-3


@pytest.mark.cuda
def test_cuda_gated_fleet_equals_masked_fleet_bit_for_bit():
    """Under ``torch.use_deterministic_algorithms`` the fleet's gated graph (its passes one WHILE node, run while any lane is
    active) computes what its masked graph computes, bit for bit, with the
    same iterations lane by lane, stream 2 ending early (its no-op lane
    keeps every pass running, as JAX's)."""
    _card()
    cfg, datas = _card_run(3, duration=1.2)
    datas[2] = dataclasses.replace(datas[2], scans=datas[2].scans[:8],
                                   scan_stamps=datas[2].scan_stamps[:8])
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("gated", "masked"):
            bp = BatchPipeline(cfg, 3)
            if mode == "masked":
                bp.graphs = StepGraphs(bp.device, gates=False)
            _feed_batch(bp, datas)
            runs[mode] = bp
    finally:
        torch.use_deterministic_algorithms(False)
    for i in range(3):
        got = _positions(runs["gated"].get_trajectory(i))
        assert np.isfinite(got).all() and len(got) >= 6
        np.testing.assert_array_equal(
            got, _positions(runs["masked"].get_trajectory(i)))
        assert [d.iterations for d in runs["gated"].get_diags(i)] == [
            d.iterations for d in runs["masked"].get_diags(i)]
    assert all(s["gated"] for s in runs["gated"].graphs.stats().values())


@pytest.mark.cuda
def test_cuda_batch_steady_state_makes_no_sync():
    """After the capture, the rounds run under
    ``set_sync_debug_mode("error")``: no host sync a round."""
    _card()
    cfg, datas = _card_run(2, duration=1.2)
    bp = BatchPipeline(cfg, 2)
    first = [dataclasses.replace(d, scans=d.scans[:6],
                                 scan_stamps=d.scan_stamps[:6]) for d in datas]
    _feed_batch(bp, first)
    assert all(bp.map_built) and bp.graphs.stats()
    t6 = [d.scan_stamps[5] + 0.1 + 1e-9 for d in datas]
    rest = [dataclasses.replace(
        d, scans=d.scans[6:], scan_stamps=d.scan_stamps[6:],
        imu_t=d.imu_t[d.imu_t > t], imu_acc=d.imu_acc[d.imu_t > t],
        imu_gyr=d.imu_gyr[d.imu_t > t]) for d, t in zip(datas, t6)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rounds = _feed_batch(bp, rest)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rounds >= 4
    assert all(np.isfinite(_positions(bp.get_trajectory(i))).all()
               for i in range(2))

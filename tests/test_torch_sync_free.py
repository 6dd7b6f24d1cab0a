"""The per-scan step with no host read, and its CUDA graphs.

The port's step is the counterpart of the JAX package's jitted step
(``fast_lio_tpu/pipeline.py:744-746``: "NO host<->device syncs below"): every
``lax.cond`` became a ``control_flow.gate`` on a device flag and the
``lax.while_loop`` a ``control_flow.while_loop`` (arms and passes that all
run and a ``torch.where`` that picks, or in a captured step CUDA-graph IF
nodes and one WHILE node), and every
``mode="drop"`` scatter a write to a dump row, so on CUDA the step is
captured in one CUDA graph per pad bucket and replayed.

On the CPU (tier 1):

* ``no_host_reads`` raises on every read of tensor data by the host
  (``Tensor.item``, ``tolist``, ``__bool__``, ``__int__``, ``__float__``,
  ``__index__``, ``torch.nonzero``, and beneath them the aten ops that read
  or size a result by the data: ``_local_scalar_dense``, ``nonzero``,
  ``masked_select``, ``unique``, boolean indexing) and on a tensor made from
  host data (``torch.tensor``, ``torch.as_tensor`` of host data,
  ``torch.from_numpy``: on CUDA a host-to-device copy, which no graph can
  record).  It wraps every step of a ``Pipeline`` run, after a warm-up run
  that makes the step's device constants, as the capture does: avia-small
  (the first scan's step has ``do_update`` False, the later ones True), a
  sparse outdoor run in each arm of the wide fallback, ``rescore_research``
  and the grouped backend.
* The fallback helper is exact against JAX's ``make_knn_fn`` in all three
  arms; the masked ``update_iterated`` matches JAX's ``while_loop`` for runs
  that exit after 1 to ``max_iter + 1`` passes (``tests/test_torch_filter.py``'s
  tolerance, 1e-9 in f64); the insert through the dump row equals JAX's, and
  a checkpoint written after it resumes in JAX.

On a card (marked ``cuda``; they skip without one): the captured step
against the eager one, two natural captured runs and the eager one bit for
bit (deterministic algorithms off), steady state under
``set_sync_debug_mode("error")``, a
checkpoint resume and a state handover into a captured pipeline, two fleet
lanes captured side by side; the sharded step captured on one NCCL rank
(``torch_shard_workers.captured_rank``): its graphs, its steady state with
no sync, against the eager rank and the captured unsharded run, a sharded
checkpoint and a handover into it; and one NCCL rank in float64, captured,
against the unsharded float64 run.  Run them on the card host, which has no JAX (this
file imports it lazily): ``python -m pytest -p no:cacheprovider --noconftest
-m cuda tests/test_torch_sync_free.py``.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch import sim as tsim
from fast_lio_tpu_torch import state as tst
from fast_lio_tpu_torch.batch import BatchPipeline
from fast_lio_tpu_torch.filter import ekf as tekf
from fast_lio_tpu_torch.kernels import counts as tcounts
from fast_lio_tpu_torch.kernels import knn as tknn
from fast_lio_tpu_torch.kernels import knn_grouped as tkg
from fast_lio_tpu_torch.map import hash_map as thm
from fast_lio_tpu_torch.parallel import ShardGroup, launch
from fast_lio_tpu_torch.step_graph import captures_by_default
from fast_lio_tpu_torch.utils import checkpoint as tckpt
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
import torch_shard_workers as w
from torch_shard_workers import SPARSE
from torch_shard_workers import sparse_outdoor as _sparse_outdoor

POS_TOL_M = 5e-3  # the captured step against the eager one on the card
SMALL = dict(lidar_type=tcfg.LidarType.AVIA, det_range=450.0,
             n_points_max=2048, n_ds_max=1024, map_h_log2=12)


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------


class HostRead(AssertionError):
    """The step read tensor data on the host, or made a tensor from it."""


_ATEN_READS = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
               "_unique", "_unique2", "unique_dim", "unique_consecutive",
               "is_nonzero", "equal", "masked_scatter", "masked_scatter_"}
_ATEN_INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_"}


class _AtenReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _ATEN_READS:
            raise HostRead(f"aten.{name} reads the data on the host")
        if name in _ATEN_INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] if i is not None):
            raise HostRead(f"aten.{name} with a boolean index sizes its "
                           "result by the data")
        return func(*args, **(kwargs or {}))


def _raising(what):
    def method(*args, **kwargs):
        raise HostRead(what)
    return method


def _host_data(fn, what):
    def made(data, *args, **kwargs):
        if isinstance(data, torch.Tensor):
            return fn(data, *args, **kwargs)
        raise HostRead(what)
    return made


@contextlib.contextmanager
def no_host_reads():
    """Raise ``HostRead`` on any host read of tensor data (and any tensor
    made from host data) inside the block."""
    tensor_methods = ("item", "tolist", "__bool__", "__int__", "__float__",
                      "__index__")
    missing = object()
    saved = [(torch.Tensor, n, torch.Tensor.__dict__.get(n, missing))
             for n in tensor_methods]
    saved += [(torch, n, getattr(torch, n))
              for n in ("nonzero", "tensor", "as_tensor", "from_numpy")]
    try:
        for n in tensor_methods:
            setattr(torch.Tensor, n, _raising(f"Tensor.{n} reads the device"))
        torch.nonzero = _raising("torch.nonzero sizes its result by the data")
        torch.tensor = _raising("torch.tensor copies host data in")
        torch.from_numpy = _raising("torch.from_numpy copies host data in")
        torch.as_tensor = _host_data(saved[-2][2],
                                     "torch.as_tensor copies host data in")
        with _AtenReads():
            yield
    finally:
        for owner, n, orig in saved:
            if orig is missing:
                delattr(owner, n)
            else:
                setattr(owner, n, orig)


_CASES_OF_READS = {
    "item": lambda t: t.sum().item(),
    "tolist": lambda t: t.tolist(),
    "bool": lambda t: bool(t.any()),
    "int": lambda t: int(t.sum()),
    "float": lambda t: float(t.sum()),
    "index": lambda t: [0, 1, 2][t.sum().long()],
    "if": lambda t: 1 if t.any() else 0,
    "nonzero": lambda t: torch.nonzero(t),
    "where_one_arg": lambda t: torch.where(t > 0),
    "boolean_index": lambda t: t[t > 0],
    "boolean_index_put": lambda t: t.clone().__setitem__(t > 0, 1.0),
    "host_constant": lambda t: t + torch.tensor(1.0),
    "unique": lambda t: torch.unique(t),
}


@pytest.mark.parametrize("read", sorted(_CASES_OF_READS))
def test_guard_raises_on_each_read(read):
    t = torch.arange(3.0)
    with pytest.raises(HostRead):
        with no_host_reads():
            _CASES_OF_READS[read](t)
    # and everything is back after the block
    assert int(t.sum()) == 3 and t.tolist() == [0.0, 1.0, 2.0]
    assert torch.tensor(1.0).item() == 1.0


def test_guard_lets_device_work_through():
    t = torch.arange(6.0).reshape(2, 3)
    flag = t.sum() > 3
    with no_host_reads():
        out = torch.where(flag, t @ t.T, torch.zeros(2, 2))
        idx = torch.full((4,), 1, dtype=torch.int64)
        out = out[idx] + torch.as_tensor(out)[idx]
    assert out.shape == (4, 2)


# ---------------------------------------------------------------------------
# the step under the guard
# ---------------------------------------------------------------------------


def _feed(pipe, data, empty_scans=()):
    """Push a sim run through the packet API (scans listed in
    ``empty_scans`` arrive with no point)."""
    imu_i = 0
    for k in range(len(data.scans)):
        stamp = data.scan_stamps[k]
        while imu_i < len(data.imu_t) and data.imu_t[imu_i] <= stamp + 0.1 + 1e-9:
            pipe.push_imu(data.imu_t[imu_i], data.imu_acc[imu_i],
                          data.imu_gyr[imu_i])
            imu_i += 1
        if k in empty_scans:
            pipe.push_lidar(stamp, np.zeros((0, 3), np.float32), np.zeros(0))
        else:
            pipe.push_lidar(stamp, data.scans[k], data.scan_pt_times[k])
        while pipe.spin_once():
            pass


def _small_sim(duration=1.0, seed=0):
    return tsim.generate(tsim.SimConfig(duration=duration, n_rings=8,
                                        n_azimuth=200, range_noise=0.01,
                                        seed=seed))


GUARDED_RUNS = {
    # name: (Config keywords, sim, scans that arrive empty)
    "avia_small": (SMALL, _small_sim, ()),
    "sparse_outdoor_fallback": (SPARSE, _sparse_outdoor, (4,)),
    "rescore_research": (dict(SMALL, rescore_research=True), _small_sim, ()),
    "grouped_backend": (dict(SMALL, knn_backend="grouped"), _small_sim, ()),
}


@pytest.mark.parametrize("name", sorted(GUARDED_RUNS))
def test_step_reads_nothing_on_the_host(name, monkeypatch):
    """Every step of the run under the guard: the first (``do_update``
    False: it seeds the map) and the later ones (True).  The fallback run
    records each fallback's ``n_unsat`` and its budget and meets all three
    arms: none unsaturated (the empty scan), at most K_w, more than K_w."""
    kw, make_data, empty = GUARDED_RUNS[name]
    cfg = tcfg.Config(**kw)
    data = make_data()
    # the warm-up, as before a capture: the step's device constants are
    # made at their first use (later steps find them made)
    warm = tpipe.Pipeline(cfg, device="cpu")
    _feed(warm, dataclasses.replace(data, scans=data.scans[:3],
                                    scan_stamps=data.scan_stamps[:3]))
    assert len(warm.trajectory) >= 1

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
        arms.append((torch.sum((~found[:, -1] | (sq[:, -1] > rcov2)) & mask),
                     K_w))
        return out

    monkeypatch.setattr(tpipe, "wide_fallback", recording)
    pipe = tpipe.Pipeline(cfg, device="cpu")
    flags = []
    step = pipe._packed_step

    def guarded(buf):
        flags.append(bool(buf[6] > 0.5))
        with no_host_reads():
            return step(buf)

    pipe._packed_step = guarded
    _feed(pipe, data, empty_scans=empty)
    assert flags[0] is False and flags[1:] and all(flags[1:])
    pos = np.stack([p for _, p, _ in pipe.get_trajectory()])
    assert len(pos) == len(flags) and np.isfinite(pos).all()
    assert not pipe.health_check()["nan"]
    if name == "sparse_outdoor_fallback":
        counts = {(int(n) == 0, int(n) <= k) for n, k in arms}
        assert counts == {(True, True), (False, True), (False, False)}, arms


# ---------------------------------------------------------------------------
# the fallback helper, the masked update, the dump-row insert, against JAX
# ---------------------------------------------------------------------------


def _jax():
    """The JAX side, imported on first use (the card host has none)."""
    import jax.numpy as jnp

    from fast_lio_tpu import pipeline as jpipe
    from fast_lio_tpu.config import Config as JConfig
    from fast_lio_tpu.map import hash_map as jhm
    return types.SimpleNamespace(jnp=jnp, jpipe=jpipe, JConfig=JConfig,
                                 jhm=jhm)


def _sparse_maps():
    """The same sparse map in both packages (5-voxel cells), with queries
    around it and a mask: (map cfg, port map, JAX map, queries, mask)."""
    J = _jax()
    rng = np.random.default_rng(6)
    cfg = thm.make_config(voxel_size=0.5, h_log2=10, cell_multiplier=5)
    pts = np.concatenate([
        np.column_stack([rng.uniform(-20, 20, 1500), rng.uniform(-20, 20, 1500),
                         np.zeros(1500)]),
        np.column_stack([np.full(600, 15.0), rng.uniform(-20, 20, 600),
                         rng.uniform(0, 6, 600)])]).astype(np.float32)
    on = np.ones(len(pts), bool)
    tm = thm.insert(thm.make_map(cfg), cfg, torch.tensor(pts),
                    torch.tensor(on), torch.tensor(~on))
    jcfg = J.jhm.MapConfig(*cfg)
    jm = J.jhm.insert(J.jhm.make_map(jcfg), jcfg, J.jnp.asarray(pts),
                      J.jnp.asarray(on), J.jnp.asarray(~on))
    np.testing.assert_array_equal(tm.packed.numpy(), np.asarray(jm.packed))
    near = pts[rng.integers(0, len(pts), 440)] + rng.normal(0, 0.3, (440, 3))
    far = rng.uniform([-24, -24, -1], [24, 24, 7], size=(72, 3))
    q = np.concatenate([near, far]).astype(np.float32)
    mask = rng.uniform(size=512) < 0.9
    return cfg, tm, jm, q, mask


FALLBACK_ARMS = ("none_unsaturated", "partial_wide", "full_wide_over_budget")


@pytest.mark.parametrize("arm", FALLBACK_ARMS)
def test_wide_fallback_matches_jax_in_each_arm(arm):
    """``make_knn_fn``'s fallback (``wide_fallback``) against JAX's: found,
    squared distances and neighbours where found, bit for bit, with the
    budget or mask that puts ``n_unsat`` in each arm; under the guard."""
    import jax

    J = _jax()
    cfg, tm, jm, q, mask = _sparse_maps()
    _nb, sq, found = thm.knn_search(tm, cfg, torch.tensor(q))
    unsat = (~found[:, -1] | (sq[:, -1] > (0.5 * cfg.cell_size) ** 2)).numpy()
    n_unsat = int((unsat & mask).sum())
    assert 8 < n_unsat < 200  # the scene has queries of both kinds
    K_w = {"none_unsaturated": 64, "partial_wide": n_unsat + 5,
           "full_wide_over_budget": n_unsat // 2}[arm]
    if arm == "none_unsaturated":
        mask = mask & ~unsat
    kw = dict(knn_wide_fallback=True, knn_wide_max_queries=K_w)
    t_fn = tpipe.make_knn_fn(tcfg.Config(**kw), cfg, tm)
    j_fn = J.jpipe.make_knn_fn(J.JConfig(**kw), J.jhm.MapConfig(*cfg), jm)
    qt, mt = torch.tensor(q), torch.tensor(mask)
    t_fn(qt, mt)  # the warm-up makes the search's device constants
    with no_host_reads():
        got = t_fn(qt, mt)
    # op by op, as the port runs (compiled, XLA fuses the squared distances
    # and rounds some of them differently in the last bit)
    with jax.disable_jit():
        want = [np.asarray(a)
                for a in j_fn(J.jnp.asarray(q), J.jnp.asarray(mask))]
    nb, sq, f = (a.numpy() for a in got)
    np.testing.assert_array_equal(f, want[2])
    np.testing.assert_array_equal(sq, want[1])
    np.testing.assert_array_equal(nb[f], want[0][want[2]])
    if arm != "none_unsaturated":  # the wide search found what it could
        assert (f[mask].sum() > found.numpy()[mask].sum())


UPDATE_CASES = {
    # name: (max_iter, epsi, invalid calls, passes the loop makes)
    "one_pass": (0, 1e-3, (), 1),
    "converged_twice": (4, 1e3, (), 2),
    "invalid_first_pass": (4, 1e3, (0,), 3),
    "two_invalid_passes": (4, 1e3, (0, 1), 4),
    "never_converges_forced_research": (4, 1e-14, (), 5),
    "invalid_pass_and_forced_research": (4, 1e-14, (1,), 5),
    "all_invalid": (3, 1e-3, (0, 1, 2, 3), 4),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_masked_update_iterated_matches_jax(case):
    """The masked passes against JAX's ``while_loop`` on a measurement model
    written with device ops only (its Jacobian refreshed where ``converge``
    is set, the kNN re-search's analog), under the guard: the iterate, P,
    the carry (the same re-searches happened, the same calls counted),
    the iterations and the valid flag."""
    import jax

    from fast_lio_tpu import state as jst
    from fast_lio_tpu.filter import ekf as jekf
    from test_torch_filter import _close, _spd, _states

    J = _jax()
    max_iter, epsi, invalid, passes = UPDATE_CASES[case]
    rng = np.random.default_rng(24)
    N = 96
    H0 = rng.normal(size=(N, 12))
    mask = rng.uniform(size=N) < 0.8
    dx0 = rng.normal(size=23) * 0.05
    jx0, tx0 = _states(dx0)
    dxt = dx0.copy()
    dxt[:12] += rng.normal(size=12) * 0.03
    jxt, txt = _states(dxt)
    P0 = _spd(rng, 23, 0.1)
    R = 1e-3
    bad = np.asarray(sorted(invalid) or [-1])

    def j_fn(x, converge, carry):
        H_old, calls = carry
        e = jst.boxminus(jxt, x)[:12]
        H = J.jnp.where(converge, J.jnp.asarray(H0) * (1.0 + 0.2 * J.jnp.cos(e)),
                        H_old)
        z = H @ e
        valid = ~J.jnp.any(calls == J.jnp.asarray(bad))
        return jekf.MeasOut(H, z + 0.05 * J.jnp.sin(z), J.jnp.asarray(mask),
                            valid, (H, calls + 1))

    H0_t, mask_t, bad_t = (torch.tensor(H0), torch.tensor(mask),
                           torch.tensor(bad))

    def t_fn(x, converge, carry):
        H_old, calls = carry
        e = tst.boxminus(txt, x)[:12]
        H = torch.where(converge, H0_t * (1.0 + 0.2 * torch.cos(e)), H_old)
        z = H @ e
        valid = ~torch.any(calls == bad_t)
        return tekf.MeasOut(H, z + 0.05 * torch.sin(z), mask_t, valid,
                            (H, calls + 1))

    jres = jax.jit(lambda x, P: jekf.update_iterated(
        x, P, j_fn, (J.jnp.zeros((N, 12)), J.jnp.asarray(0, J.jnp.int32)),
        R, max_iter, epsi))(jx0, J.jnp.asarray(P0))
    carry0 = (torch.zeros(N, 12, dtype=torch.float64),
              torch.zeros((), dtype=torch.int32))
    P0_t = torch.tensor(P0)
    tekf.update_iterated(tx0, P0_t, t_fn, carry0, R, max_iter, epsi)  # warm
    with no_host_reads():
        tres = tekf.update_iterated(tx0, P0_t, t_fn, carry0, R, max_iter, epsi)

    assert int(jres.iterations) == passes
    assert int(tres.iterations) == passes
    assert bool(tres.valid) == bool(jres.valid)
    for got, want in zip(tres.x, jres.x):
        _close(got, want)
    _close(tres.P, jres.P)
    _close(tres.carry[0], jres.carry[0])  # the same re-searches happened
    assert int(tres.carry[1]) == int(jres.carry[1]) == passes
    if case == "all_invalid":
        _close(tres.P, P0, 0)


def test_dump_row_insert_matches_jax():
    """Rows the insert masks off (not added, or over a full bucket) write
    the dump row after the H buckets: the buckets equal JAX's, and the map's
    shape, size and drop count are JAX's."""
    J = _jax()
    rng = np.random.default_rng(8)
    cfg = thm.MapConfig(h_log2=4, bucket_slots=8, cell_size=2.0,
                        voxel_size=0.5)
    pts = rng.uniform(-6, 6, size=(700, 3)).astype(np.float32)
    add = rng.uniform(size=700) < 0.7
    ds = rng.uniform(size=700) < 0.5
    m0 = thm.make_map(cfg)
    before_dump = m0.rows[-1].clone()  # the row the map carries after H
    args = (torch.tensor(pts), torch.tensor(add), torch.tensor(ds))
    with no_host_reads():
        tm = thm.insert(m0, cfg, *args)
    jcfg = J.jhm.MapConfig(*cfg)
    jm = J.jhm.insert(J.jhm.make_map(jcfg), jcfg, J.jnp.asarray(pts),
                      J.jnp.asarray(add), J.jnp.asarray(ds))
    assert tuple(tm.packed.shape) == tuple(jm.packed.shape) == (16, 32)
    np.testing.assert_array_equal(tm.packed.numpy(), np.asarray(jm.packed))
    assert int(tm.dropped) == int(jm.dropped) > 0  # full buckets dropped some
    assert int(thm.map_size(tm)) == int(J.jhm.map_size(jm))
    # the masked rows landed in the dump row, outside everything above
    dump = tm.rows[-1]
    assert tm.packed.data_ptr() == tm.rows.data_ptr()  # packed = rows[:H]
    assert not torch.equal(dump, before_dump)
    assert np.isin(dump[0].item(), pts[:, 0])


def test_insert_refuses_a_map_without_its_dump_row():
    cfg = thm.MapConfig(h_log2=4, bucket_slots=8, cell_size=2.0,
                        voxel_size=0.5)
    bare = thm.Map(packed=thm.make_map(cfg).packed.clone(),
                   dropped=torch.zeros((), dtype=torch.int32))
    pts = torch.zeros((4, 3))
    on = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="dump row"):
        thm.insert(bare, cfg, pts, on, on)
    m = thm.from_packed(bare.packed, bare.dropped)
    assert torch.equal(m.packed, bare.packed)
    thm.insert(m, cfg, pts, on, on)
    assert int(thm.map_size(m)) == 1


def test_checkpoint_after_dump_row_inserts_resumes_in_jax(tmp_path):
    """A port run (every insert through the dump row) saved and resumed by
    the JAX package: the map JAX loads is the port's bit for bit, at JAX's
    shape, and the next scans agree within the pipeline tests' 5 mm."""
    from fast_lio_tpu.config import Config as JConfig
    from fast_lio_tpu.config import LidarType as JLidarType
    from fast_lio_tpu.pipeline import Pipeline as JPipeline
    from fast_lio_tpu.pipeline import ScanPacket as JScanPacket
    from fast_lio_tpu.utils import checkpoint as jckpt

    data = _small_sim(1.2)
    kw = {k: v for k, v in SMALL.items() if k != "lidar_type"}
    pt = tpipe.Pipeline(tcfg.Config(lidar_type=tcfg.LidarType.AVIA, **kw),
                        device="cpu")
    _feed(pt, dataclasses.replace(data, scans=data.scans[:8],
                                  scan_stamps=data.scan_stamps[:8]))
    assert pt.map_built and int(thm.map_size(pt.map)) > 0
    tckpt.save_pipeline(tmp_path / "port.npz", pt)
    pj = JPipeline(JConfig(lidar_type=JLidarType.AVIA, **kw))
    jckpt.load_pipeline(tmp_path / "port.npz", pj)
    assert tuple(pj.map.packed.shape) == tuple(pt.map.packed.shape)
    np.testing.assert_array_equal(np.asarray(pj.map.packed),
                                  pt.map.packed.numpy())
    # the same next packets through both
    pkts = []
    tail = dataclasses.replace(data, scans=data.scans[8:],
                               scan_stamps=data.scan_stamps[8:])
    pt.process_packet = pkts.append  # collect the synced packets
    _feed(pt, tail)
    del pt.process_packet
    assert len(pkts) >= 3
    for pkt in pkts:
        pt.process_packet(pkt)
        pj.process_packet(JScanPacket(**dataclasses.asdict(pkt)))
        np.testing.assert_allclose(pt.get_trajectory()[-1][1],
                                   pj.get_trajectory()[-1][1], rtol=0,
                                   atol=POS_TOL_M)


# ---------------------------------------------------------------------------
# the Pipeline's state and options
# ---------------------------------------------------------------------------


def test_graphs_option_and_device():
    cfg = tcfg.Config(**SMALL)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        tpipe.Pipeline(cfg, device="cpu", graphs=True)
    fake_group = types.SimpleNamespace(device=torch.device("cpu"),
                                       backend="gloo", capturable=False)
    with pytest.raises(ValueError, match="gloo group: its collectives copy"):
        tpipe.Pipeline(cfg, group=fake_group, graphs=True)
    pipe = tpipe.Pipeline(cfg, device="cpu")
    assert pipe.graphs is None and pipe.feed is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.Pipeline(cfg)


def test_capture_default_by_device_and_group():
    """The step is captured by default on CUDA, alone or on NCCL ranks;
    never on the CPU, nor on gloo ranks (on a card or not)."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")

    def group(backend, device):
        return ShardGroup(None, 0, 1, device, backend)

    assert captures_by_default(cuda)
    assert captures_by_default(cuda, group("nccl", cuda))
    assert group("nccl", cuda).capturable
    assert not captures_by_default(cuda, group("gloo", cuda))
    assert not captures_by_default(cpu)
    assert not captures_by_default(cpu, group("gloo", cpu))
    assert not any(group("gloo", d).capturable for d in (cuda, cpu))


def test_nccl_group_drains_between_graph_and_eager_launches(monkeypatch):
    """NCCL runs with graph mixing support off: a group drains the card
    where a graph replay follows an eager collective or the reverse, never
    between two launches of one kind, nor while capturing; gloo never."""
    syncs, capturing = [], [False]
    monkeypatch.setattr(torch.cuda, "synchronize", syncs.append)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    cuda = torch.device("cuda", 0)
    g = ShardGroup(None, 0, 1, cuda, "nccl")
    for kind, drains in (("eager", 0), ("eager", 0), ("graph", 1),
                         ("graph", 1), ("eager", 2), ("graph", 3)):
        g.launching(kind)
        assert g.in_flight.drains == drains and len(syncs) == drains
    capturing[0] = True  # a capture records its collectives: no launch
    g.launching("eager")
    assert g.in_flight.kind == "graph" and len(syncs) == 3
    assert syncs == [cuda] * 3
    capturing[0] = False
    other = ShardGroup(None, 0, 1, cuda, "nccl")  # a group of its own
    other.launching("graph")
    assert other.in_flight.drains == 0 and g.in_flight.drains == 3
    gloo = ShardGroup(None, 0, 1, cuda, "gloo")
    for kind in ("eager", "graph", "eager"):
        gloo.launching(kind)
    assert gloo.in_flight.kind is None and len(syncs) == 3


def test_state_lives_in_place_and_kept_outputs_are_copies():
    """``load_state`` writes into the pipeline's tensors (the ones a graph
    reads); what a scan keeps does not change under later scans."""
    cfg = dataclasses.replace(tcfg.Config(**SMALL), runtime_pos_log=True)
    pipe = tpipe.Pipeline(cfg, device="cpu")
    ptrs = [v.data_ptr() for v in (*pipe.x, pipe.P, pipe.map.packed,
                                   pipe.map.dropped, *pipe.imu_carry,
                                   *pipe.lm_state)]
    data = _small_sim()
    _feed(pipe, dataclasses.replace(data, scans=data.scans[:6],
                                    scan_stamps=data.scan_stamps[:6]))
    first = [p.clone() for _, p, _ in pipe.trajectory]
    logged = [v.clone() for v in pipe.state_log[0][1]]
    _feed(pipe, data)
    assert ptrs == [v.data_ptr() for v in (*pipe.x, pipe.P, pipe.map.packed,
                                           pipe.map.dropped, *pipe.imu_carry,
                                           *pipe.lm_state)]
    for (_, p, _), want in zip(pipe.trajectory, first):
        assert torch.equal(p, want)
    for got, want in zip(pipe.state_log[0][1], logged):
        assert torch.equal(got, want)
    assert not torch.equal(pipe.state_log[0][1].pos, pipe.x.pos)
    with pytest.raises(ValueError, match="shape"):
        pipe.load_state(P=torch.eye(3, dtype=torch.float32))


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _positions(pipe):
    return np.stack([p for _, p, _ in pipe.get_trajectory()])


def _avia_run():
    cfg = tcfg.PRESETS["avia"]
    return cfg, tsim.generate(tsim.SimConfig(duration=2.2, n_rings=32,
                                             n_azimuth=400))


def _ouster_two_buckets():
    """ouster64 at chip_smoke.py's pad, with a second bucket of half its
    size; every other scan keeps every other point (the sim's scans all
    hold 44032), so the scans go to both."""
    data = tsim.generate(tsim.SimConfig(duration=2.0, n_rings=64,
                                        n_azimuth=688, elev_min=-22.5,
                                        elev_max=22.5))
    cut = [k % 2 == 1 for k in range(len(data.scans))]
    data = dataclasses.replace(
        data, scans=[s[::2] if c else s for s, c in zip(data.scans, cut)],
        scan_pt_times=[t[::2] if c else t
                       for t, c in zip(data.scan_pt_times, cut)])
    cfg = dataclasses.replace(tcfg.PRESETS["ouster64"], n_points_max=45056,
                              pad_buckets=(22528, 45056))
    assert max(len(s) for s in data.scans[1::2]) <= 22528
    return cfg, data


def _avia_rescore():
    cfg, data = _avia_run()
    return dataclasses.replace(cfg, rescore_research=True), data


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["avia", "avia_rescore_research",
                                 "ouster64_two_buckets"])
def test_cuda_captured_step_equals_eager(run):
    _card()
    cfg, data = {"avia": _avia_run, "avia_rescore_research": _avia_rescore,
                 "ouster64_two_buckets": _ouster_two_buckets}[run]()
    eager = tpipe.Pipeline(cfg, graphs=False)
    _feed(eager, data)
    tcounts.settle()
    before = sum(tknn.launches.values()) + sum(tkg.launches.values())
    cand_before = tknn.cand_launches[8]
    captured = tpipe.Pipeline(cfg)
    _feed(captured, data)
    a, b = _positions(eager), _positions(captured)
    assert a.shape == b.shape and len(a) >= 15 and np.isfinite(b).all()
    assert np.abs(a - b).max() <= POS_TOL_M
    stats = captured.graphs.stats()
    assert len(stats) == len(cfg.pad_buckets or (1,))
    assert all(s["replays"] > 0 for s in stats.values())
    # the single step's graph is gated: every re-search's kNN launch sits
    # in a conditional node and counts as run, on the device; outside them
    # a replay launches the set kernels of the two outermost IF nodes (the
    # prune's and the update's, which holds the filter's WHILE node) and
    # the downsample's segment_sum kernel; rescore_research adds the scan's
    # one search before the update, the candidates kernel (whose block the
    # passes re-rank in plain torch ops, as the JAX package does in XLA),
    # and launches no other kNN kernel
    outside = 4 if cfg.rescore_research else 3
    assert all(s["gated"] and s["launches_per_replay"] == outside
               for s in stats.values())
    tcounts.settle()
    knn_ran = sum(tknn.launches.values()) + sum(tkg.launches.values())
    assert (knn_ran > before) != cfg.rescore_research
    steps = len(captured.diags) if cfg.rescore_research else 0
    assert tknn.cand_launches[8] - cand_before == steps
    assert eager.graphs is None


@pytest.mark.cuda
def test_cuda_steady_state_makes_no_sync():
    _card()
    cfg, data = _avia_run()
    pipe = tpipe.Pipeline(cfg)
    n = len(data.scans)
    _feed(pipe, dataclasses.replace(data, scans=data.scans[:6],
                                    scan_stamps=data.scan_stamps[:6]))
    assert pipe.map_built and pipe.graphs.stats()
    rest = dataclasses.replace(data, scans=data.scans[6:],
                               scan_stamps=data.scan_stamps[6:])
    # the IMU samples up to scan 6 are already pushed: skip them
    t6 = data.scan_stamps[5] + 0.1 + 1e-9
    keep = data.imu_t > t6
    rest = dataclasses.replace(rest, imu_t=data.imu_t[keep],
                               imu_acc=data.imu_acc[keep],
                               imu_gyr=data.imu_gyr[keep])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _feed(pipe, rest)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(pipe.trajectory) >= n - 3
    assert np.isfinite(_positions(pipe)).all()


@pytest.mark.cuda
def test_cuda_natural_runs_are_bit_equal():
    """Two captured runs of the same scans and the eager run, with
    deterministic algorithms off: bit-equal positions and covariances, the
    same iterations scan by scan.  The downsample's segment sums are the
    ``segment_mean`` kernel's, summed in one order on every run
    (``index_add_`` on CUDA adds with atomics, in another order each run,
    and the last bits moved a convergence test by a pass)."""
    _card()
    assert not torch.are_deterministic_algorithms_enabled()
    cfg, data = _avia_run()
    from fast_lio_tpu_torch.kernels import segment_sum as tseg

    tcounts.settle()
    before = tseg.launches[32]
    runs = []
    for graphs in (True, True, False):
        pipe = tpipe.Pipeline(cfg, graphs=graphs)
        _feed(pipe, data)
        runs.append(pipe)
    tcounts.settle()
    assert tseg.launches[32] - before == sum(len(p.diags) for p in runs)
    first = runs[0]
    assert len(first.diags) >= 15
    for pipe in runs[1:]:
        assert np.array_equal(_positions(pipe), _positions(first))
        assert torch.equal(pipe.P, first.P)
        assert ([int(d.iterations) for d in pipe.diags]
                == [int(d.iterations) for d in first.diags])


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["checkpoint", "state_handover"])
def test_cuda_state_loaded_into_a_captured_pipeline(how, tmp_path):
    """A captured pipeline that has run (and captured) takes the state of
    another run at scan k, by a checkpoint or by ``convert``'s handover, and
    continues as the uninterrupted run does (5 mm)."""
    _card()
    cfg, data = _avia_run()
    ref = tpipe.Pipeline(cfg)
    _feed(ref, data)
    k = 9
    first = dataclasses.replace(data, scans=data.scans[:k],
                                scan_stamps=data.scan_stamps[:k])
    src = tpipe.Pipeline(cfg)
    _feed(src, first)
    target = tpipe.Pipeline(cfg)
    _feed(target, dataclasses.replace(data, scans=data.scans[:4],
                                      scan_stamps=data.scan_stamps[:4]))
    assert target.graphs.stats()  # captured before the state comes in
    w.take_over(target, src, how, tmp_path / "ck.npz")
    imu_i = int(np.searchsorted(data.imu_t, data.scan_stamps[k - 1] + 0.1
                                + 1e-9, side="right"))
    rest = dataclasses.replace(data, scans=data.scans[k:],
                               scan_stamps=data.scan_stamps[k:],
                               imu_t=data.imu_t[imu_i:],
                               imu_acc=data.imu_acc[imu_i:],
                               imu_gyr=data.imu_gyr[imu_i:])
    _feed(target, rest)
    a, b = _positions(ref), _positions(target)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= POS_TOL_M


@pytest.mark.cuda
def test_cuda_two_fleet_lanes_captured_side_by_side():
    _card()
    cfg = tcfg.PRESETS["avia"]
    datas = [tsim.generate(tsim.SimConfig(duration=1.6, n_rings=32,
                                          n_azimuth=400, seed=s))
             for s in (0, 1)]
    singles = []
    for d in datas:
        p = tpipe.Pipeline(cfg)
        _feed(p, d)
        singles.append(_positions(p))
    bp = BatchPipeline(cfg, 2)
    imu = [0, 0]
    for k in range(len(datas[0].scans)):
        for i, d in enumerate(datas):
            stamp = d.scan_stamps[k]
            while imu[i] < len(d.imu_t) and d.imu_t[imu[i]] <= stamp + 0.1 + 1e-9:
                bp.push_imu(i, d.imu_t[imu[i]], d.imu_acc[imu[i]],
                            d.imu_gyr[imu[i]])
                imu[i] += 1
            bp.push_lidar(i, stamp, d.scans[k], d.scan_pt_times[k])
        while bp.spin_once():
            pass
    stats = bp.graphs.stats()  # one graph for the fleet, per pad bucket
    assert stats and all(s["replays"] > 0 for s in stats.values())
    for i in range(2):
        got = np.stack([p for _, p, _ in bp.get_trajectory(i)])
        assert got.shape == singles[i].shape
        assert np.abs(got - singles[i]).max() <= POS_TOL_M


@pytest.fixture(scope="module")
def nccl_rank(tmp_path_factory):
    """``torch_shard_workers.captured_rank`` on one NCCL rank, once for the
    tests below."""
    _card()
    return launch(w.captured_rank, 1, args=(
        str(tmp_path_factory.mktemp("nccl_rank")),), backend="nccl")[0]


@pytest.mark.cuda
def test_cuda_nccl_rank_captures_one_graph_per_bucket(nccl_rank):
    """A sharded pipeline on an NCCL rank captures by default: one gated
    graph per pad bucket, replayed for every later step, its kNN launches
    counted as run (in its IF nodes, on the device), at most the eager
    step's, which runs every pass and re-search."""
    r = nccl_rank
    assert r["transport"] == "nccl" and r["device"].startswith("cuda")
    graphs, steps = r["graphs"], len(r["captured"])
    assert 1 <= len(graphs) <= len(r["pad_buckets"])
    assert sum(g["replays"] for g in graphs.values()) == steps - len(graphs)
    assert all(g["launches_per_replay"] > 0 for g in graphs.values())
    assert all(g["gated"] for g in graphs.values())
    assert r["eager_graphs"] is None
    assert all(n <= r["eager_launches"][k]
               for k, n in r["captured_launches"].items())
    assert r["captured_launches"][8] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("other", ["eager", "unsharded"])
def test_cuda_nccl_rank_captured_equals(nccl_rank, other):
    """The captured rank, its steady state under
    ``set_sync_debug_mode("error")`` (any host sync raises), within 5 mm per
    scan of the same rank eager and of the captured unsharded pipeline."""
    a, b = nccl_rank["captured"], nccl_rank[other]
    assert a.shape == b.shape and len(a) >= 15 and np.isfinite(a).all()
    assert np.abs(a - b).max() <= POS_TOL_M


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["checkpoint", "state_handover"])
def test_cuda_state_loaded_into_a_captured_nccl_rank(nccl_rank, how):
    """A captured sharded pipeline takes the state of another run at a
    later scan, by a sharded checkpoint or by ``convert``'s handover, and
    continues as the uninterrupted captured run does (5 mm)."""
    got = nccl_rank[how]
    assert got["had_graphs"]
    a, b = nccl_rank["captured"], got["positions"]
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= POS_TOL_M


@pytest.fixture(scope="module", params=[1, 4], ids=lambda n: f"world{n}")
def two_bucket_ranks(request):
    """``torch_shard_workers.two_bucket_rank`` on n NCCL ranks, one card
    each; skips unless there are n cards."""
    _card()
    n = request.param
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices, one a rank")
    return launch(w.two_bucket_rank, n, backend="nccl")


@pytest.mark.cuda
def test_cuda_nccl_ranks_capture_a_second_bucket_after_replays(
        two_bucket_ranks):
    """A sharded pipeline on NCCL ranks meets its second pad bucket after
    replays of the first: the group drains the replays before the eager
    all-gather and warm-up of the new bucket (NCCL's graph mixing support
    is off), never in the steady state (run under
    ``set_sync_debug_mode("error")``), and again before ``health_check``'s
    eager all-reduce.  Both buckets are captured gated and replayed; the
    ranks' trajectories are bit-identical and within 5 mm per scan of the
    unsharded captured run."""
    first, steady = w.TWO_BUCKET_FIRST, w.TWO_BUCKET_STEADY
    r0 = two_bucket_ranks[0]
    assert r0["pads"][first] == 2048 and r0["pads"][first + 1] == 1024
    for r in two_bucket_ranks:
        graphs = r["graphs"]  # by feed buffer length
        assert len(graphs) == 2
        assert all(g["gated"] and g["replays"] > 0 for g in graphs.values())
        # the scan that captured the second bucket, after the first's
        # replays: the drains grew there, and not after it
        k = r["n_graphs"].index(2)
        assert first <= k < steady - 1 and r["n_graphs"][k - 2] == 1
        d = r["drains"]
        assert d[k] > d[k - 1]
        assert d[k] == d[steady - 1] == r["steady_drains"]
        assert r["health_drains"] == r["steady_drains"] + 1
        assert not r["health"]["nan"]
        np.testing.assert_array_equal(r["positions"], r0["positions"])
    a, b = r0["positions"], r0["unsharded"]
    assert a.shape == b.shape and len(a) >= 15 and np.isfinite(a).all()
    assert np.abs(a - b).max() <= POS_TOL_M


def one_rank_f64_against_unsharded(group) -> dict:
    """(Run on a rank by ``parallel.launch``.)  A small float64 sim run
    through the sharded pipeline on one rank and through the unsharded one
    on the same device."""
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, filter_size_surf=0.3,
                      filter_size_map=0.3, n_points_max=2048, n_ds_max=1024,
                      n_imu_max=32, map_h_log2=12, det_range=40.0,
                      cube_side_length=300.0, compute_dtype="float64")
    data = tsim.generate(tsim.SimConfig(duration=1.2, n_rings=8, n_azimuth=200,
                                        range_noise=0.01))
    out = {}
    for name, pipe in (("sharded", tpipe.Pipeline(cfg, group=group)),
                       ("unsharded", tpipe.Pipeline(cfg, device=group.device))):
        _feed(pipe, data)
        out[name] = _positions(pipe)
        out[f"{name}_dtype"] = str(pipe.x.pos.dtype)
        out[f"{name}_graphs"] = len(pipe.graphs.stats())
    out["transport"] = group.transport
    out["device"] = str(group.device)
    return out


@pytest.mark.cuda
def test_cuda_one_nccl_rank_float64_equals_unsharded_run():
    """ROADMAP.md C: the sharded step in float64 over NCCL, one rank, against
    the unsharded float64 run on the card, both captured (the default):
    within 1e-6 m per scan (the float64 tolerance of
    tests/test_torch_pipeline.py)."""
    _card()
    res = launch(one_rank_f64_against_unsharded, 1, backend="nccl")[0]
    assert res["transport"] == "nccl" and res["device"].startswith("cuda")
    assert res["sharded_graphs"] >= 1 and res["unsharded_graphs"] >= 1
    assert res["sharded_dtype"] == res["unsharded_dtype"] == "torch.float64"
    assert res["sharded"].shape == res["unsharded"].shape
    assert np.isfinite(res["sharded"]).all()
    assert np.abs(res["sharded"] - res["unsharded"]).max() <= 1e-6


def ranks_against_unsharded(group) -> dict:
    """(Run on each of n NCCL ranks by ``parallel.launch``.)
    ``one_rank_f64_against_unsharded`` at n ranks, and the float32 run of
    the same scans with the wide fallback through the sharded pipeline:
    its state, which every rank holds bit for bit."""
    out = one_rank_f64_against_unsharded(group)
    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, filter_size_surf=0.3,
                      filter_size_map=0.3, n_points_max=2048, n_ds_max=1024,
                      n_imu_max=32, map_h_log2=12, det_range=40.0,
                      cube_side_length=300.0, knn_wide_fallback=True)
    pipe = tpipe.Pipeline(cfg, group=group)
    _feed(pipe, tsim.generate(tsim.SimConfig(duration=1.2, n_rings=8,
                                             n_azimuth=200, range_noise=0.01)))
    out["f32_state"] = dict(
        {f: v.cpu().numpy() for f, v in zip(pipe.x._fields, pipe.x)},
        P=pipe.P.cpu().numpy(), positions=_positions(pipe))
    out["f32_graphs"] = len(pipe.graphs.stats())
    out["rank"] = group.rank
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"world{n}")
def nccl_ranks(request):
    """``ranks_against_unsharded`` on n NCCL ranks, one card each, once per
    world size; skips unless there are n cards."""
    _card()
    n = request.param
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices, one a rank")
    return launch(ranks_against_unsharded, n, backend="nccl")


@pytest.mark.cuda
def test_cuda_nccl_ranks_float64_equal_unsharded_run(nccl_ranks):
    """The sharded step captured on n NCCL ranks (the collectives in every
    rank's graph) in float64, against the unsharded float64 captured run
    on each rank's card: within 1e-6 m per scan, as at one rank."""
    assert [r["rank"] for r in nccl_ranks] == list(range(len(nccl_ranks)))
    for res in nccl_ranks:
        assert res["transport"] == "nccl" and res["device"].startswith("cuda")
        assert res["sharded_graphs"] >= 1 and res["unsharded_graphs"] >= 1
        assert (res["sharded_dtype"] == res["unsharded_dtype"]
                == "torch.float64")
        assert res["sharded"].shape == res["unsharded"].shape
        assert np.isfinite(res["sharded"]).all()
        assert np.abs(res["sharded"] - res["unsharded"]).max() <= 1e-6
    assert len({r["device"] for r in nccl_ranks}) == len(nccl_ranks)


@pytest.mark.cuda
def test_cuda_nccl_ranks_hold_the_same_state(nccl_ranks):
    """In float32, captured on n NCCL ranks with the wide fallback: every
    rank's state, covariance and trajectory bit for bit."""
    s0 = nccl_ranks[0]["f32_state"]
    assert all(r["f32_graphs"] >= 1 for r in nccl_ranks)
    assert np.isfinite(s0["positions"]).all() and len(s0["positions"]) >= 8
    for r in nccl_ranks[1:]:
        assert r["f32_state"].keys() == s0.keys()
        for k, v in r["f32_state"].items():
            np.testing.assert_array_equal(v, s0[k])

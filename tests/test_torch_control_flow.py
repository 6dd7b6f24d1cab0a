"""The step's control flow as JAX writes it (``control_flow.py``).

On the CPU (tier 1):

* ``associative_scan`` against ``jax.lax.associative_scan`` at lengths 1,
  2, 3, 7, 8, 63 and 64: bit-equal with a non-associative integer combine
  (``3 a + b`` in int64, equal only where the association tree is JAX's)
  and with ``max``; the IMU's two combines, ``quat_multiply`` and the
  (F, G) composition, within rounding (f64 1e-12; f32 1e-6 on unit
  quaternions, 1e-5 of the largest entry on the 23x23 products: XLA's and
  torch's products round otherwise, the order is the same); and under
  ``torch.func.vmap``, bit-equal to one scan a row.
* ``associative_last`` (the last element alone) bit for bit
  ``associative_scan``'s last element at lengths 1-70, on tensors and
  tuples, eagerly and under ``torch.func.vmap``.
* ``gate``: the masked form is ``torch.where`` of the body and the carry;
  a gated capture that cannot record an IF node raises (on the CPU, and
  wherever no graph is being captured).
* ``while_loop``: the masked form against ``jax.lax.while_loop`` on a
  seeded carry, bit for bit, where ``done`` turns True at a data-dependent
  pass and where it never does (``i < max_iter`` ends the loop after
  ``max_iter + 1`` passes); under ``torch.func.vmap`` against
  ``jax.vmap(lax.while_loop)`` with lanes that stop at different passes,
  masked and with the WHILE node a host loop (``while any lane is active:
  body``), which runs the most passes any lane runs; a gated capture that
  cannot record a WHILE node raises; an update whose every pass is
  invalid runs ``max_iter + 1`` passes, host loop and masked alike, and
  stops.
* The gated step with each IF node a host branch (``if bool(pred):
  body``) and its WHILE node a host loop: a CPU pipeline run in float64
  with the wide fallback equals the masked run bit for bit, its per-scan
  iterations equal the JAX pipeline's and the passes the loop entered (none
  after ``done``), and the gates skip work: scans that make fewer than
  ``max_iteration + 1`` passes, skipped re-searches, wide searches and
  prunes.

On a card (marked ``cuda``; they skip without one): gated capture of a
carry through nested IF nodes with the update's library calls (Cholesky,
triangular solves, batched products), replayed with each predicate; a
WHILE node bit for bit the masked loop, alone and nested in an IF body
with an IF node in its own body, and ending after ``max_iter + 1`` passes
where ``done`` never turns True (each replay within a time limit); the
single pipeline's gated graph against the eager, masked step and against
the same graph with its gates masked, bit for bit with equal per-scan
iterations under ``torch.use_deterministic_algorithms``; its steady state
with
no sync under ``set_sync_debug_mode("error")``; and the kNN launches the
counters report as run equal to the profiler's count of kNN kernels.
``python -m pytest -p no:cacheprovider --noconftest -m cuda
tests/test_torch_control_flow.py`` (the card's host has no JAX: this file
imports it lazily).
"""
import contextlib
import dataclasses
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import control_flow as cf
from fast_lio_tpu_torch import pipeline as tpipe
from fast_lio_tpu_torch import sim as tsim
from fast_lio_tpu_torch.kernels import counts
from fast_lio_tpu_torch.kernels import knn as tknn
from fast_lio_tpu_torch.math import so3 as tso3
from fast_lio_tpu_torch.step_graph import StepGraphs
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LENGTHS = (1, 2, 3, 7, 8, 63, 64)


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _jax_scan(fn, elems):
    """``jax.lax.associative_scan`` jitted (one compile, not an op a
    dispatch)."""
    jax, _ = _jax()
    return jax.jit(lambda e: jax.lax.associative_scan(fn, e))(elems)


def _compose_torch(a, b):  # a precedes b, as imu.propagate_and_deskew's
    Fa, Ga = a
    Fb, Gb = b
    return Fb @ Fa, Fb @ Ga @ Fb.transpose(-1, -2) + Gb


def _compose_jax(a, b):  # fast_lio_tpu/imu.py's compose
    jax, jnp = _jax()
    Fa, Ga = a
    Fb, Gb = b
    return Fb @ Fa, Fb @ Ga @ jnp.swapaxes(Fb, -1, -2) + Gb


@pytest.mark.parametrize("n", LENGTHS)
def test_scan_association_order_is_jax(n):
    jax, jnp = _jax()
    rng = np.random.default_rng(n)
    ints = rng.integers(-5, 6, n).astype(np.int64)
    want = _jax_scan(lambda a, b: 3 * a + b, jnp.asarray(ints))
    got = cf.associative_scan(lambda a, b: 3 * a + b, torch.from_numpy(ints))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a left fold (the port's loops before) gives other answers from n = 4
    with np.errstate(over="ignore"):  # int64 wraps, as in both scans
        fold = np.array(list(itertools.accumulate(
            ints, lambda a, b: 3 * a + b)))
    assert np.array_equal(fold, got.numpy()) == (n < 4)
    vals = rng.normal(size=(n, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        cf.associative_scan(torch.maximum, torch.from_numpy(vals)).numpy(),
        np.asarray(_jax_scan(jnp.maximum, jnp.asarray(vals))))


@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("n", LENGTHS)
def test_scan_of_the_imu_combines_matches_jax(n, dt):
    jax, jnp = _jax()
    from fast_lio_tpu.math import so3 as jso3
    rng = np.random.default_rng(100 + n)
    q = rng.normal(size=(n, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(dt)
    want = _jax_scan(jso3.quat_multiply, jnp.asarray(q))
    got = cf.associative_scan(tso3.quat_multiply, torch.from_numpy(q))
    qtol = 1e-12 if dt == "float64" else 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=qtol)

    F = (np.eye(23) + 0.05 * rng.normal(size=(n, 23, 23))).astype(dt)
    A = rng.normal(size=(n, 23, 23)) * 1e-2
    G = (A @ np.swapaxes(A, -1, -2)).astype(dt)
    with jax.default_matmul_precision("highest"):
        wF, wG = _jax_scan(_compose_jax, (jnp.asarray(F), jnp.asarray(G)))
    gF, gG = cf.associative_scan(_compose_torch,
                                 (torch.from_numpy(F), torch.from_numpy(G)))
    rel = 1e-12 if dt == "float64" else 1e-5
    for got_m, want_m in ((gF, wF), (gG, wG)):
        want_m = np.asarray(want_m)
        np.testing.assert_allclose(got_m.numpy(), want_m, rtol=0,
                                   atol=rel * np.abs(want_m).max())


@pytest.mark.parametrize("n", range(1, 71))
def test_last_element_alone_is_the_scans_last(n):
    """``associative_last`` bit for bit ``associative_scan(...)[-1]``: on a
    tensor (the non-associative ``3 a + b`` in int64, the quaternion
    product) and on a tuple (the (F, G) composition, f32 and f64), eagerly
    and under ``torch.func.vmap``."""
    rng = np.random.default_rng(200 + n)
    ints = torch.from_numpy(rng.integers(-5, 6, n).astype(np.int64))
    fold = lambda a, b: 3 * a + b  # noqa: E731
    assert torch.equal(cf.associative_last(fold, ints),
                       cf.associative_scan(fold, ints)[-1])
    for dt in (torch.float32, torch.float64):
        q = torch.from_numpy(rng.normal(size=(n, 4))).to(dt)
        assert torch.equal(cf.associative_last(tso3.quat_multiply, q),
                           cf.associative_scan(tso3.quat_multiply, q)[-1])
        F = (torch.eye(23, dtype=torch.float64) + 0.05 * torch.from_numpy(
            rng.normal(size=(2, n, 23, 23)))).to(dt)
        A = torch.from_numpy(rng.normal(size=(2, n, 23, 23))) * 1e-2
        G = (A @ A.transpose(-1, -2)).to(dt)
        last = cf.associative_last(_compose_torch, (F[0], G[0]))
        scan = cf.associative_scan(_compose_torch, (F[0], G[0]))
        assert all(torch.equal(a, b[-1]) for a, b in zip(last, scan))
        last = torch.func.vmap(
            lambda f, g: cf.associative_last(_compose_torch, (f, g)))(F, G)
        scan = torch.func.vmap(lambda f, g: tuple(
            e[-1] for e in cf.associative_scan(_compose_torch, (f, g))))(F, G)
        assert all(torch.equal(a, b) for a, b in zip(last, scan))


def test_scan_runs_under_vmap():
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(3, 9, 4)))
    batched = torch.func.vmap(
        lambda e: cf.associative_scan(tso3.quat_multiply, e))(q)
    for b in range(3):
        assert torch.equal(batched[b],
                           cf.associative_scan(tso3.quat_multiply, q[b]))


def test_masked_gate_is_a_select():
    carry = (torch.arange(4.0), (torch.ones(2, dtype=torch.int32),))

    def body(c):
        return c[0] * 2 + 1, (c[1][0] - 3,)

    for flag in (True, False):
        got = cf.gate(torch.tensor(flag), body, carry)
        want = body(carry) if flag else carry
        assert torch.equal(got[0], want[0]) and torch.equal(got[1][0],
                                                            want[1][0])
    assert not cf.gating()
    assert cf.own(carry) is carry  # the masked form writes nothing


def test_a_gated_capture_that_cannot_record_raises():
    carry = (torch.zeros(3),)
    with cf.gated_capture("cpu"):
        assert cf.gating()
        with pytest.raises(RuntimeError, match="not capturing"):
            cf.gate(torch.tensor(True), lambda c: (c[0] + 1,), carry)
        assert cf.own(carry)[0] is not carry[0]
    assert not cf.gating() and torch.equal(carry[0], torch.zeros(3))
    # a group whose collectives no graph can record (gloo) still refuses a
    # gated capture; an NCCL group takes one (its gates hold collectives)
    # (gates=True is the default)
    gloo = SimpleNamespace(backend="gloo", capturable=False)
    with pytest.raises(ValueError, match="cannot be recorded"):
        StepGraphs("cpu", group=gloo)
    nccl = SimpleNamespace(backend="nccl", capturable=True)
    assert StepGraphs("cpu", group=nccl).gates


def _loop_carry(x0, tol):
    """The loop's carry: (i, done, x, passes, tol), i from -1."""
    x0 = torch.from_numpy(np.asarray(x0))
    return (x0.new_full((), -1, dtype=torch.int32),
            x0.new_zeros((), dtype=torch.bool), x0,
            x0.new_zeros((), dtype=torch.int32), x0.new_full((), tol))


def _loop_body(c):
    """x halves its distance to 0.5 a pass; done once the step is below
    tol (never where tol is 0)."""
    i, done, x, passes, tol = c
    x_new = x * 0.5 + 0.25
    return (i + 1, (x_new - x).abs().max() < tol, x_new, passes + 1, tol)


def _jax_loop(x0, tol, max_iter):
    jax, jnp = _jax()

    def cond(c):
        return ~c[1] & (c[0] < max_iter)

    def body(c):
        i, done, x, passes, tol = c
        x_new = x * 0.5 + 0.25
        return (i + 1, jnp.abs(x_new - x).max() < tol, x_new, passes + 1,
                tol)

    def loop(x, tol):
        init = (jnp.asarray(-1, jnp.int32), jnp.asarray(False), x,
                jnp.asarray(0, jnp.int32), tol)
        return jax.lax.while_loop(cond, body, init)

    x0, tol = jnp.asarray(x0), jnp.asarray(tol)
    fn = jax.vmap(loop) if x0.ndim == 2 else loop
    return [np.asarray(v) for v in jax.jit(fn)(x0, tol)]


def _assert_loop_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


LOOP_MAX_ITER = 6


@pytest.mark.parametrize("tol", [0.05, 0.0], ids=["done_at_data", "never"])
def test_masked_while_loop_is_jax_while_loop(tol):
    rng = np.random.default_rng(11)
    x0 = rng.normal(size=7)
    got = cf.while_loop(_loop_body, _loop_carry(x0, tol), LOOP_MAX_ITER)
    want = _jax_loop(x0, tol, LOOP_MAX_ITER)
    _assert_loop_equal(got, want)
    n = int(got[3])
    if tol:  # done at a pass the data chose
        assert bool(got[1]) and 1 < n < LOOP_MAX_ITER + 1
    else:  # the index ends it
        assert not bool(got[1]) and n == LOOP_MAX_ITER + 1
        assert int(got[0]) == LOOP_MAX_ITER


def _host_while(passes: list):
    """A WHILE node as a host loop: the body while any lane is active (each
    lane's condition written into ``active`` first, where given, as the
    condition kernel writes it), the passes it ran appended to
    ``passes``."""
    def host_while(done, i, max_iter, fn, active=None):
        n = 0
        while True:
            cond = ~done & (i < max_iter)
            if active is not None:
                active.copy_(cond)
            if not bool(cond.any()):
                break
            fn()
            n += 1
        passes.append(n)
    return host_while


def _lanes_x0():
    """Four lanes whose loops stop at different passes (the last never)."""
    rng = np.random.default_rng(12)
    x0 = rng.normal(size=(4, 5)) * np.array([0.2, 1.0, 6.0, 1.0])[:, None]
    return x0, np.array([0.05, 0.05, 0.05, 0.0])


@pytest.mark.parametrize("form", ["masked", "host_while"])
def test_vmapped_while_loop_is_jax_vmapped_while_loop(form, monkeypatch):
    x0, tol = _lanes_x0()
    passes = []
    monkeypatch.setattr(cf, "_record_while", _host_while(passes))

    def loop(x, t):
        carry = (x.new_full((), -1, dtype=torch.int32),
                 x.new_zeros((), dtype=torch.bool), x.clone(),
                 x.new_zeros((), dtype=torch.int32), t.clone())
        return cf.while_loop(_loop_body, carry, LOOP_MAX_ITER)

    gated = (cf.gated_capture("cpu") if form == "host_while"
             else contextlib.nullcontext())
    with gated:
        got = torch.func.vmap(loop)(torch.from_numpy(x0),
                                    torch.from_numpy(tol))
    want = _jax_loop(x0, tol, LOOP_MAX_ITER)
    _assert_loop_equal(got, want)
    lane_passes = got[3].tolist()
    assert len(set(lane_passes)) > 2 and max(lane_passes) == LOOP_MAX_ITER + 1
    # the host loop ran while any lane was active: the most any lane ran
    assert passes == ([max(lane_passes)] if form == "host_while" else [])


def test_a_gated_while_loop_that_cannot_record_raises():
    carry = _loop_carry(np.zeros(3), 0.0)
    with cf.gated_capture("cpu"):
        with pytest.raises(RuntimeError, match="not capturing"):
            cf.while_loop(_loop_body, carry, 2)
    assert int(carry[0]) == -1 and torch.equal(carry[2], torch.zeros(3,
                                               dtype=torch.float64))
    # a WHILE node reads one flag a lane: not a vector a lane
    with pytest.raises(ValueError, match="one flag a lane"):
        torch.func.vmap(cf._lanes)(torch.zeros((3, 2), dtype=torch.bool))


def test_host_while_of_an_update_with_no_valid_pass_stops_at_max_iter(
        monkeypatch):
    """A scan whose every pass is invalid never sets ``done``: the WHILE
    node runs ``max_iter + 1`` passes, as the masked form does, and stops
    with the state unchanged."""
    from fast_lio_tpu_torch import state as tst
    from fast_lio_tpu_torch.filter import ekf as tekf
    rng = np.random.default_rng(4)
    N, max_iter = 32, 3
    x0 = tst.identity_state(torch.float64)
    A = rng.normal(size=(23, 23))
    P0 = torch.from_numpy(A @ A.T / 23 + np.eye(23) * 1e-3)
    H = torch.from_numpy(rng.normal(size=(N, 12)))

    def h_fn(x, converge, carry):
        return tekf.MeasOut(H, H[:, 0] * 0.1, torch.ones(N, dtype=torch.bool),
                            torch.zeros((), dtype=torch.bool), carry + 1)

    masked = tekf.update_iterated(x0, P0, h_fn, torch.zeros(()), 1e-3,
                                  max_iter)
    passes = []
    monkeypatch.setattr(cf, "_record_while", _host_while(passes))
    with cf.gated_capture("cpu"):
        gated = tekf.update_iterated(x0, P0, h_fn, torch.zeros(()), 1e-3,
                                     max_iter)
    assert passes == [max_iter + 1]
    for res in (masked, gated):
        assert int(res.iterations) == max_iter + 1 and not bool(res.valid)
        assert int(res.carry) == max_iter + 1  # h_fn ran once a pass
        assert torch.equal(res.P, P0)
        assert all(torch.equal(a, b) for a, b in zip(res.x, x0))


def _feed(pipe, data):
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


# phase_small's run of chip_smoke.py with the wide fallback, at a budget
# of 64 queries: both of JAX's wide arms
SMALL_WIDE = dict(filter_size_surf=0.3, filter_size_map=0.3,
                  n_points_max=2048, n_ds_max=1024, n_imu_max=32,
                  map_h_log2=12, det_range=40.0, cube_side_length=300.0,
                  knn_wide_fallback=True, map_cell_multiplier=3,
                  knn_wide_max_queries=64)


def _small_wide(dtype):
    return (tcfg.Config(lidar_type=tcfg.LidarType.AVIA, compute_dtype=dtype,
                        **SMALL_WIDE),
            tsim.generate(tsim.SimConfig(duration=1.3, n_rings=8,
                                         n_azimuth=200, range_noise=0.01)))


def _run_record(pipe_cfg, data, device="cpu"):
    pipe = tpipe.Pipeline(pipe_cfg, device=device)
    _feed(pipe, data)
    return pipe


def test_host_branch_gates_equal_the_masked_run_and_jax(monkeypatch):
    """The gated step's semantics on the CPU: each IF node a host branch."""
    from fast_lio_tpu.config import Config as JConfig
    from fast_lio_tpu.config import LidarType as JLidarType
    from fast_lio_tpu.pipeline import Pipeline as JPipeline

    cfg, data = _small_wide("float64")
    masked = _run_record(cfg, data)

    taken = {True: 0, False: 0}
    bodies = []

    def host_if(pred, fn):
        flag = bool(pred)
        taken[flag] += 1
        if flag:
            bodies.append(fn)
            fn()

    passes = []
    monkeypatch.setattr(cf, "_record_if", host_if)
    monkeypatch.setattr(cf, "_record_while", _host_while(passes))
    with cf.gated_capture("cpu"):
        gated = _run_record(cfg, data)
    assert taken[True] > 0 and taken[False] > 0

    traj_m, traj_g = masked.get_trajectory(), gated.get_trajectory()
    assert len(traj_m) == len(traj_g) >= 10
    for (t0, p0, q0), (t1, p1, q1) in zip(traj_m, traj_g):
        assert t0 == t1 and np.array_equal(p0, p1) and np.array_equal(q0, q1)
    assert torch.equal(masked.P, gated.P)
    assert torch.equal(masked.map.packed, gated.map.packed)
    it_m = [int(d.iterations) for d in masked.diags]
    it_g = [int(d.iterations) for d in gated.diags]
    assert it_m == it_g
    assert [int(d.n_effective) for d in masked.diags] == [
        int(d.n_effective) for d in gated.diags]
    assert min(i for i in it_g if i > 0) < cfg.max_iteration + 1
    # one WHILE loop an update, which entered as many passes as JAX's loop
    # counts (every pass counts one): none after done
    assert passes == [i for i in it_g if i > 0]

    jp = JPipeline(JConfig(lidar_type=JLidarType.AVIA,
                           compute_dtype="float64", **SMALL_WIDE))
    _feed(jp, data)
    assert [int(d.iterations) for d in jp.diags] == it_g
    np.testing.assert_allclose(
        np.stack([p for _, p, _ in traj_g]),
        np.stack([p for _, p, _ in jp.get_trajectory()]), rtol=0, atol=1e-6)


def test_host_branch_gates_skip_the_dead_work(monkeypatch):
    """Which gates a host branch skips on the small wide run: re-searches
    after a pass that did not converge, wide searches with no unsaturated
    query, prunes of a cube that did not move; and the host loop, the
    passes after the exit."""
    cfg, data = _small_wide("float32")
    skipped = []
    calls = []

    def host_if(pred, fn):
        calls.append(bool(pred))
        if bool(pred):
            fn()

    real_gate = cf.gate

    def named_gate(pred, body, carry):
        n = len(calls)
        out = real_gate(pred, body, carry)
        skipped.append((getattr(body, "__name__", "?"), not calls[n]))
        return out

    passes = []
    monkeypatch.setattr(cf, "_record_if", host_if)
    monkeypatch.setattr(cf, "_record_while", _host_while(passes))
    monkeypatch.setattr(cf, "gate", named_gate)
    with cf.gated_capture("cpu"):
        _run_record(cfg, data)
    # the filter's loop stopped short of its last pass on some scan
    assert passes and 0 < min(passes) < cfg.max_iteration + 1
    by_body = {}
    for name, skip in skipped:
        by_body.setdefault(name, [0, 0])[skip] += 1
    # every kind of gate ran, and each but the wide search was skipped too:
    # some query at the map's edge is unsaturated on every search of this
    # run (the next test skips that gate)
    for name in ("research", "widen", "prune", "run_update"):
        assert name in by_body, sorted(by_body)
        ran, skip = by_body[name]
        assert ran > 0 and (skip > 0) == (name != "widen"), (name, ran, skip)


def test_host_branch_skips_the_wide_search_with_no_unsaturated_query(
        monkeypatch):
    monkeypatch.setattr(cf, "_record_if",
                        lambda pred, fn: fn() if bool(pred) else None)
    rng = np.random.default_rng(5)
    N = 16
    narrow = (torch.from_numpy(rng.normal(size=(N, 5, 3))),
              torch.full((N, 5), 0.01, dtype=torch.float64),
              torch.ones((N, 5), dtype=torch.bool))
    searched = []

    def base(q, wide=False):
        searched.append(wide)
        if not wide:
            return tuple(t.clone() for t in narrow)
        return tuple(torch.zeros_like(t) for t in narrow)

    q = torch.zeros((N, 3), dtype=torch.float64)
    mask = torch.ones(N, dtype=torch.bool)
    with cf.gated_capture("cpu"):
        out = tpipe.wide_fallback(base, q, mask, rcov2=1.0, K_w=4)
    assert searched == [False]
    assert all(torch.equal(a, b) for a, b in zip(out, narrow))
    with cf.gated_capture("cpu"):  # one query unsaturated: the wide search
        out = tpipe.wide_fallback(base, q, mask.clone(), rcov2=0.001, K_w=4)
    assert searched == [False, False, True]
    assert all(torch.equal(a, torch.zeros_like(a)) for a in out)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_cuda_nested_if_nodes_with_the_update_calls():
    """A carry through three nested IF nodes whose bodies make the update's
    library calls, replayed with every choice of the predicates."""
    _card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    A0 = torch.tensor(rng.normal(size=(23, 23)), dtype=torch.float32,
                      device=dev)
    flags = torch.zeros(3, dtype=torch.bool, device=dev)

    def step(flags):
        S = A0 @ A0.T + 23 * torch.eye(23, device=dev)
        carry = (S.clone(), torch.zeros(23, device=dev),
                 torch.zeros((), dtype=torch.int32, device=dev))

        def inner(c):
            S, v, k = c
            return S, v + torch.ones_like(v), k + 100

        def middle(c):
            S, v, k = c
            L, _ = torch.linalg.cholesky_ex(S)
            y = torch.linalg.solve_triangular(L, S[:, :1], upper=False)
            v2 = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
            S2, v3, k2 = cf.gate(flags[2], inner, (S @ S.T * 1e-3, v + v2,
                                                  k + 10))
            return S2, v3, k2

        def outer(c):
            S, v, k = c
            Sb = torch.bmm(S[None], S[None])[0] * 1e-2
            return cf.gate(flags[1], middle, (Sb, v, k + 1))

        return cf.gate(flags[0], outer, carry)

    def eager(fl):
        with torch.no_grad():
            return step(torch.tensor(fl, device=dev))

    static = flags.clone()
    counts.device_counter(dev)
    eager([True, True, True])  # warm every call
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph), cf.gated_capture(dev):
            out = step(static)
    torch.cuda.current_stream().wait_stream(side)
    for fl in ([False] * 3, [True, False, False], [True, True, False],
               [True, True, True], [False, True, True]):
        static.copy_(torch.tensor(fl, device=dev))
        graph.replay()
        want = eager(fl)
        torch.cuda.synchronize()
        for got_t, want_t in zip(out, want):
            torch.testing.assert_close(got_t, want_t, rtol=1e-5, atol=1e-5)


CARD_LOOP_MAX_ITER = 3  # at most 4 passes


def _card_pass(c):
    """One pass of the card's loop: i up by one, x * 0.5 + 1, done once
    ``stop`` passes ran (never where stop exceeds the passes)."""
    i, done, x, stop = c
    i1 = i + 1
    return i1, i1 + 1 >= stop, x * 0.5 + 1.0, stop


def _card_carry(x0, stop):
    return (torch.full((), -1, dtype=torch.int32, device=x0.device),
            torch.zeros((), dtype=torch.bool, device=x0.device), x0.clone(),
            torch.full((), stop, dtype=torch.int32, device=x0.device))


def _passes_run():
    from fast_lio_tpu_torch.kernels import graph_if
    counts.settle()
    return graph_if.while_launches[1]


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["alone", "in_an_if_body"])
def test_cuda_while_node_equals_the_masked_loop(where):
    """One WHILE node (its body one pass, holding an IF node when nested in
    an IF body) against the masked loop, bit for bit, with ``done`` set
    after 1 and 3 passes and never; the device's count of passes."""
    _card()
    dev = torch.device("cuda")
    x0 = torch.tensor(np.random.default_rng(8).normal(size=(8192, 5, 3)),
                      dtype=torch.float32, device=dev)
    flags = torch.ones(2, dtype=torch.bool, device=dev)

    def loop(carry):
        if where == "alone":
            return cf.while_loop(_card_pass, carry, CARD_LOOP_MAX_ITER)

        def nested_pass(c):
            i, done, x, stop = _card_pass(c)
            x = cf.gate(flags[1], lambda t: (t[0] - 0.25,), (x,))[0]
            return i, done, x, stop

        return cf.gate(flags[0], lambda c: cf.while_loop(
            nested_pass, c, CARD_LOOP_MAX_ITER), carry)

    counts.device_counter(dev)
    static = _card_carry(x0, 1)
    with torch.no_grad():
        loop(_card_carry(x0, 4))  # warm
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph), cf.gated_capture(dev):
            out = loop(static)
    torch.cuda.current_stream().wait_stream(side)
    fl_cases = [[True, True]] if where == "alone" else [
        [True, True], [True, False], [False, True]]
    for fl in fl_cases:
        flags.copy_(torch.tensor(fl, device=dev))
        for stop in (1, 3, 100):
            for s, v in zip(static, _card_carry(x0, stop)):
                s.copy_(v)
            before = _passes_run()
            graph.replay()
            ran = _passes_run() - before
            want = loop(_card_carry(x0, stop))  # masked: not capturing
            torch.cuda.synchronize()
            for got_t, want_t in zip(out, want):
                assert torch.equal(got_t, want_t), (fl, stop)
            n = min(stop, CARD_LOOP_MAX_ITER + 1) if fl[0] else 0
            assert ran == n and int(out[0]) == n - 1, (fl, stop, ran)


@pytest.mark.cuda
def test_cuda_while_node_without_done_ends_at_max_iter():
    """``done`` never set: each replay ends after ``max_iter + 1`` passes
    (the index bounds the loop), within a time limit, so that a loop that
    did not end fails here instead of stalling the run."""
    _card()
    import time
    dev = torch.device("cuda")
    x0 = torch.zeros((8192, 5, 3), device=dev)
    counts.device_counter(dev)
    static = _card_carry(x0, 10 ** 6)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph), cf.gated_capture(dev):
            out = cf.while_loop(_card_pass, static, CARD_LOOP_MAX_ITER)
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        for s, v in zip(static, _card_carry(x0, 10 ** 6)):
            s.copy_(v)
        before = _passes_run()
        graph.replay()
        ended = torch.cuda.Event()
        ended.record()
        deadline = time.monotonic() + 30.0
        while not ended.query():
            assert time.monotonic() < deadline, "the WHILE node did not end"
            time.sleep(0.01)
        assert _passes_run() - before == CARD_LOOP_MAX_ITER + 1
        assert int(out[0]) == CARD_LOOP_MAX_ITER and not bool(out[1])
        want = x0
        for _ in range(CARD_LOOP_MAX_ITER + 1):
            want = want * 0.5 + 1.0
        assert torch.equal(out[2], want)


def _small_cuda():
    cfg, data = _small_wide("float32")
    return cfg, data


def _ouster():
    cfg = dataclasses.replace(tcfg.PRESETS["ouster64"], n_points_max=45056)
    return cfg, tsim.generate(tsim.SimConfig(
        duration=1.5, n_rings=64, n_azimuth=688, elev_min=-22.5,
        elev_max=22.5))


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["small_wide", "ouster64"])
def test_cuda_gated_graph_equals_eager_bit_for_bit(run):
    """Under ``torch.use_deterministic_algorithms`` the gated graph computes what the eager, masked step computes, and what
    the same graph with its gates masked computes, bit for bit, with the
    same iterations scan by scan, while it skips re-searches."""
    _card()
    cfg, data = {"small_wide": _small_cuda, "ouster64": _ouster}[run]()
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("eager", "masked", "gated"):
            pipe = tpipe.Pipeline(cfg, graphs=mode != "eager")
            if mode == "masked":
                pipe.graphs = StepGraphs(pipe.device, gates=False)
            counts.settle()
            before = sum(tknn.launches.values())
            _feed(pipe, data)
            counts.settle()
            runs[mode] = (pipe, sum(tknn.launches.values()) - before)
    finally:
        torch.use_deterministic_algorithms(False)
    pos = {m: np.stack([p for _, p, _ in r[0].get_trajectory()])
           for m, r in runs.items()}
    iters = {m: [int(d.iterations) for d in r[0].diags]
             for m, r in runs.items()}
    assert len(pos["gated"]) >= 10 and np.isfinite(pos["gated"]).all()
    for other in ("eager", "masked"):
        np.testing.assert_array_equal(pos["gated"], pos[other])
        assert iters["gated"] == iters[other]
    stats = runs["gated"][0].graphs.stats()
    # outside any conditional node a replay launches the IMU stage's two
    # kernels (the propagation and the deskew), the set kernels of the two
    # outermost IF nodes (the prune's and the update's, which holds the
    # filter's WHILE node) and the downsample's segment_sum kernel, and no
    # kNN search
    assert stats and all(s["gated"] and s["replays"] > 0
                         and s["launches_per_replay"] == 5
                         for s in stats.values())
    # the gates skip re-searches: fewer kNN launches than the masked graph
    assert 0 < runs["gated"][1] < runs["masked"][1]


@pytest.mark.cuda
def test_cuda_gated_steady_state_makes_no_sync():
    _card()
    cfg, data = _ouster()
    pipe = tpipe.Pipeline(cfg)
    feed = _scans(pipe, data)
    for _ in range(6):
        next(feed)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in feed:
            pass
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(np.stack([p for _, p, _ in pipe.get_trajectory()])).all()


def _scans(pipe, data):
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
        yield k


@pytest.mark.cuda
def test_cuda_counted_launches_equal_the_profilers():
    _card()
    from fast_lio_tpu_torch.tools import profile_scan
    cfg, data = _ouster()
    profile_scan.start_tracing()  # before the capture (its docstring)
    pipe = tpipe.Pipeline(cfg)
    feed = _scans(pipe, data)
    for _ in range(6):
        next(feed)
    torch.cuda.synchronize()
    counts.settle()
    before = dict(tknn.launches)
    prof = profile_scan.profile_window(lambda: next(feed), 5)
    counts.settle()
    counted = sum(tknn.launches[r] - before[r] for r in before)
    assert counted > 0
    assert counted == round(5 * prof["knn_search_launches_per_scan"])

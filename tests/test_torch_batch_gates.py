"""The fleet's gates (``gate``'s rule for a batched predicate,
``while_loop`` under ``torch.func.vmap``), on the CPU.

* ``control_flow._lanes`` under ``torch.func.vmap`` is the physical (B,)
  tensor beneath a batched () flag, whose memory the lanes' in-place
  writes reach (what a WHILE node's condition kernel reads); outside vmap
  the flag itself as one lane.
* Inside ``gated_capture`` a batched predicate takes the masked form (a
  select, as JAX's ``lax.cond`` under ``jax.vmap``) and records nothing; an
  unbatched one records an IF node, also under vmap; ``while_loop`` with a
  batched ``done`` records one WHILE node that runs while any lane is
  active, each lane keeping its result only where it is active, and no
  pass where no lane is.
* The gated fleet with each IF node a host branch (``if bool(pred):
  body``) and its WHILE node a host loop: a float64 ``BatchPipeline`` on
  the small wide run, three lanes drawn with other range noise (so their
  iterations differ) and one that ends early, equals the masked batch bit
  for bit; each lane's iterations equal the JAX package's vmapped
  ``BatchPipeline``'s; the passes a round are the most any lane ran, and
  ``max_iteration + 1`` in a round with a lane that does not update (the
  first round, and the ended stream's no-op lane, whose loop never sets
  ``done``, as in JAX); the positions are within the batch step's float64
  tolerance of JAX's (1e-8, ``tests/test_torch_batch_step.py``).
"""
import dataclasses

import numpy as np
import torch

from fast_lio_tpu_torch import config as tcfg
from fast_lio_tpu_torch import control_flow as cf
from fast_lio_tpu_torch import sim as tsim
from fast_lio_tpu_torch.batch import BatchPipeline
from test_torch_batch import _feed_batch, _positions
from test_torch_control_flow import SMALL_WIDE
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

F64_TOL = 1e-8  # tests/test_torch_batch_step.py's float64 bound


def test_lanes_are_the_memory_of_a_batched_flag():
    flags = torch.tensor([True, False, True, False, False])
    seen = []

    def lane(f):
        done = f.new_zeros((), dtype=torch.bool)
        lanes = cf._lanes(done)
        done.copy_(f)  # a lane's in-place write, as a gated pass makes
        seen.append(lanes)
        return done

    torch.func.vmap(lane)(flags)
    (lanes,) = seen
    assert not cf.batched(lanes) and lanes.shape == (5,)
    assert torch.equal(lanes, flags)
    one = torch.tensor(False)
    assert cf._lanes(one).shape == (1,)
    one.fill_(True)
    assert bool(cf._lanes(one)[0])


def _host_while(passes):
    """A WHILE node as a host loop on the lanes' physical flags, writing
    each lane's condition into ``active`` before each pass, as the
    condition kernel does; the passes run appended to ``passes``."""
    def host_while(done, i, max_iter, fn, active=None):
        assert not any(cf.batched(t) for t in (done, i, active))
        assert active is not None and active.shape == done.shape
        n = 0
        while True:
            active.copy_(~done & (i < max_iter))
            if not bool(active.any()):
                break
            fn()
            n += 1
        passes.append(n)
    return host_while


def test_a_batched_predicate_stays_masked_in_a_gated_capture(monkeypatch):
    recorded, passes = [], []

    def host_if(pred, fn):
        recorded.append(bool(pred))
        if bool(pred):
            fn()

    monkeypatch.setattr(cf, "_record_if", host_if)
    monkeypatch.setattr(cf, "_record_while", _host_while(passes))
    flags = torch.tensor([True, False, True])
    vals = torch.arange(3.0)

    def body(c):
        return (c[0] * 2 + 1,)

    def pass_(c):  # one pass of a loop of at most two
        i, done, v = c
        return i + 1, done, v * 2 + 1

    def lane(f, v):
        carry = cf.own((v.clone(),))
        masked = cf.gate(f, body, carry)[0]
        shared = cf.gate(torch.tensor(True), body, cf.own((v.clone(),)))[0]
        # a lane that is done at the start runs no pass
        looped = cf.while_loop(pass_, (v.new_full((), -1, dtype=torch.int32),
                                       ~f, v.clone()), 1)[2]
        return masked, shared, looped

    with cf.gated_capture("cpu"):
        masked, shared, looped = torch.func.vmap(lane)(flags, vals)
    # the batched gate recorded nothing, the unbatched gate one IF node;
    # the loop one WHILE node that ran two passes (the active lanes' two)
    assert recorded == [True] and passes == [2]
    assert torch.equal(masked, torch.where(flags, vals * 2 + 1, vals))
    assert torch.equal(shared, vals * 2 + 1)
    assert torch.equal(looped, torch.where(flags, (vals * 2 + 1) * 2 + 1,
                                           vals))

    recorded.clear()
    passes.clear()
    with cf.gated_capture("cpu"):  # no lane active: no pass
        _, _, looped = torch.func.vmap(lane)(torch.zeros(3, dtype=torch.bool),
                                             vals)
    assert recorded == [True] and passes == [0] and torch.equal(looped, vals)


def _fleet_data():
    """Three streams of the small wide run with other range noise (seeds
    0-2), the third ending three scans early."""
    datas = [tsim.generate(tsim.SimConfig(duration=1.3, n_rings=8,
                                          n_azimuth=200, range_noise=0.01,
                                          seed=s)) for s in range(3)]
    k = len(datas[2].scans) - 3
    datas[2] = dataclasses.replace(
        datas[2], scans=datas[2].scans[:k],
        scan_pt_times=datas[2].scan_pt_times[:k],
        scan_stamps=datas[2].scan_stamps[:k])
    return datas


def test_host_branch_fleet_gates_equal_the_masked_batch_and_jax(monkeypatch):
    """The gated fleet's semantics on the CPU: each IF node a host branch."""
    from fast_lio_tpu.batch import BatchPipeline as JBatchPipeline
    from fast_lio_tpu.config import Config as JConfig
    from fast_lio_tpu.config import LidarType as JLidarType

    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, compute_dtype="float64",
                      **SMALL_WIDE)
    datas = _fleet_data()
    B = len(datas)
    masked = BatchPipeline(cfg, B, device="cpu")
    rounds = _feed_batch(masked, datas)

    passes = []  # per round: the passes the WHILE loop ran

    def host_if(pred, fn):
        assert not cf.batched(pred)
        if bool(pred):
            fn()

    gated = BatchPipeline(cfg, B, device="cpu")
    monkeypatch.setattr(cf, "_record_if", host_if)
    monkeypatch.setattr(cf, "_record_while", _host_while(passes))
    with cf.gated_capture("cpu"):
        assert _feed_batch(gated, datas) == rounds
    monkeypatch.undo()

    for i in range(B):
        tm, tg = masked.get_trajectory(i), gated.get_trajectory(i)
        assert len(tm) == len(tg) >= 8
        assert all(a[0] == b[0] and np.array_equal(a[1], b[1])
                   and np.array_equal(a[2], b[2]) for a, b in zip(tm, tg))
    # the no-op lane's state is not finite after its end (as JAX's):
    # equal where finite, and not finite at the same places
    for a, b in zip((*masked.x, masked.P, masked.map.rows),
                    (*gated.x, gated.P, gated.map.rows)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)

    # per round and lane: iterations, 0 where the lane did not update (the
    # first round, and the ended stream's no-op lane, which records none)
    iters = np.zeros((rounds, B), np.int64)
    for i in range(B):
        its = [d.iterations for d in gated.get_diags(i)]
        assert its == [d.iterations for d in masked.get_diags(i)]
        iters[:len(its), i] = its
    n_pass = cfg.max_iteration + 1
    # one loop a round (the batched update is a select, never skipped)
    assert len(passes) == rounds
    ran = passes
    want = [int(r.max()) if r.min() > 0 else n_pass for r in iters]
    assert ran == want
    live = [r for r, row in enumerate(iters) if row.min() > 0]
    assert any(ran[r] < n_pass for r in live)  # an early exit
    assert any(len(set(iters[r])) > 1 for r in live)  # lanes that differ
    ended = len(gated.get_trajectory(2))
    assert ended < rounds and all(ran[r] == n_pass
                                  for r in range(ended, rounds))

    jbp = JBatchPipeline(JConfig(lidar_type=JLidarType.AVIA,
                                 compute_dtype="float64", **SMALL_WIDE), B)
    assert _feed_batch(jbp, datas) == rounds
    for i in range(B):
        assert [int(d.iterations) for d in jbp.get_diags(i)] == [
            d.iterations for d in gated.get_diags(i)]
        np.testing.assert_allclose(
            _positions(gated.get_trajectory(i)),
            _positions(jbp.get_trajectory(i)), rtol=0, atol=F64_TOL)

"""The IMU stage's custom op ``fast_lio_tpu_torch::propagate_and_deskew``
(``kernels/imu.py``) and its kernels (``csrc/imu.cu``).

On the CPU (tier 1): the op is the plain version
(``imu.propagate_and_deskew_plain``) bit for bit, eagerly and under
``torch.func.vmap`` over lanes (the vmap of the plain version, Q shared),
on blocks with a stale prefix, garbage in the padded slots, no valid pair
at all, and ``deskew=False`` (MARSIM), in f32 and f64 (the feed float32,
as the pipeline's, and float64, which only the plain version takes);
``opcheck`` holds its schema, fake and vmap registrations; the kernels'
input check refuses a float64 feed.

On a card (marked ``cuda``; they skip without one): the kernels against
the plain version on the card at M in {8, 16, 32, 64, 256} IMU slots and
N in {4096, 32768} points, f32 and f64 (the feed f32), one lane and four
(Q shared), with and
without the deskew, within ``tests/test_torch_imu.py``'s tolerances (f32:
state and carry 1e-6, points 1e-6 relative and 1e-5, P 2e-5 of its
largest entry; f64 1e-10) and bit for bit from run to run; in a captured
graph with the tracer's stamps on, a replay counted as 2 launches (1
without the deskew).  ``python -m pytest -p no:cacheprovider --noconftest
-m cuda tests/test_torch_imu_kernel.py`` (no JAX here: the card's host has
none).
"""
import collections

import numpy as np
import pytest
import torch

from fast_lio_tpu_torch import imu as timu
from fast_lio_tpu_torch import state as tst
from fast_lio_tpu_torch import tracing
from fast_lio_tpu_torch.kernels import counts as tcounts
from fast_lio_tpu_torch.kernels import imu as kimu
from fast_lio_tpu_torch.tools import microbench_imu as mbi
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (computing type, the feed's type): the kernels take a float32 feed alone
# (the pipeline's); the plain version, and so the op on the CPU, either
DTYPES = {"f32": (torch.float32, torch.float32),
          "f64": (torch.float64, torch.float32),
          "f64_feed64": (torch.float64, torch.float64)}
CUDA_DTYPES = ("f32", "f64")
TOLS = mbi.TOLS
CASES = mbi.BLOCKS
_flat, _stack, _vmapped = mbi.flat, mbi.stack, mbi.vmapped


def _inputs(case, M, N, dtype, feed, seed, device="cpu"):
    return mbi.inputs(case, M, N, dtype, feed, seed, device)


def _op(x, P, Q, imu_t, acc, gyr, mask, scale, last, pcl, carry, pts, ptt,
        deskew=True):
    """The custom op itself, as ``propagate_and_deskew``'s results."""
    out = torch.ops.fast_lio_tpu_torch.propagate_and_deskew(
        *x, P, Q, *carry, imu_t, acc, gyr, scale, last, pcl, pts, ptt, mask,
        deskew)
    return (tst.State(*out[:8]), out[8], out[11] if deskew else pts,
            timu.ImuCarry(out[9], out[10]))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_op_on_cpu_is_the_plain_version(case, dt):
    dtype, feed = DTYPES[dt]
    args, deskew = _inputs(case, 24, 64, dtype, feed, seed=3)
    want = _flat(timu.propagate_and_deskew_plain(*args, deskew=deskew))
    for fn in (_op, timu.propagate_and_deskew):
        got = _flat(fn(*args, deskew=deskew))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    if not deskew:
        assert got[9] is args[11]  # pts itself


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("case", ["stale_prefix", "no_deskew"])
def test_op_under_vmap_is_the_plain_version(case, dt):
    """The op under vmap, each lane the plain version's bits on it; and
    ``imu.propagate_and_deskew`` under vmap on CPU tensors the plain
    version under vmap."""
    dtype, feed = DTYPES[dt]
    lanes = [_inputs(c, 16, 32, dtype, feed, seed=s)[0] for s, c in
             enumerate((case, "padded", "no_valid"))]
    args = _stack(lanes)
    deskew = case != "no_deskew"
    got = _vmapped(_op, args, deskew)
    for b, lane in enumerate(lanes):
        one = _flat(timu.propagate_and_deskew_plain(*lane, deskew=deskew))
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)
    got = _vmapped(timu.propagate_and_deskew, args, deskew)
    want = _vmapped(timu.propagate_and_deskew_plain, args, deskew)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_kernels_take_a_float32_feed_alone():
    args, _ = _inputs("padded", 8, 16, torch.float64, torch.float64, seed=5)
    x, P, Q, imu_t, acc, gyr, mask, scale, last, pcl, carry, pts, ptt = args
    with pytest.raises(ValueError, match="imu_t must be torch.float32"):
        kimu.check_inputs((*x, P, Q, *carry, imu_t, acc, gyr, scale, last,
                           pcl, pts, ptt, mask))


def test_opcheck():
    args, _ = _inputs("padded", 8, 16, torch.float64, torch.float64, seed=5)
    x, P, Q, imu_t, acc, gyr, mask, scale, last, pcl, carry, pts, ptt = args
    for deskew in (True, False):
        torch.library.opcheck(
            torch.ops.fast_lio_tpu_torch.propagate_and_deskew.default,
            (*x, P, Q, *carry, imu_t, acc.contiguous(), gyr.contiguous(),
             scale, last, pcl, pts, ptt, mask, deskew))


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the IMU kernels have no CPU "
                    "version (the CPU runs the plain one)")


def _index(counter) -> int:
    """``counter``'s place in ``counts.counters()`` (by identity: two
    counters may hold equal counts)."""
    return [id(c) for c in tcounts.counters()].index(id(counter))


def _assert_close(got, want, dtype):
    tol, ptol = TOLS[dtype]
    names = [*tst.State._fields, "P", "pts", "angvel_last", "acc_s_last"]
    for name, g, w in zip(names, got, want):
        g, w = g.double().cpu().numpy(), w.double().cpu().numpy()
        if name == "P":
            np.testing.assert_allclose(g, w, rtol=ptol,
                                       atol=ptol * np.abs(w).max(),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=(
                10 * tol if name == "pts" else tol), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", CUDA_DTYPES)
@pytest.mark.parametrize("M,N", [(8, 4096), (16, 4096), (32, 32768),
                                 (64, 4096), (64, 32768), (256, 4096)])
def test_cuda_kernels_match_the_plain_version(M, N, dt):
    _card()
    dtype, feed = DTYPES[dt]
    for case in CASES:
        args, deskew = _inputs(case, M, N, dtype, feed, seed=M + N,
                               device="cuda")
        before = tcounts.snapshot()
        got = _flat(timu.propagate_and_deskew(*args, deskew=deskew))
        again = _flat(timu.propagate_and_deskew(*args, deskew=deskew))
        launched = tcounts.since(before)
        want = _flat(timu.propagate_and_deskew_plain(*args, deskew=deskew))
        torch.cuda.synchronize()
        _assert_close(got, want, dtype)
        for g, a in zip(got, again):
            assert torch.equal(g, a)
        i = _index(kimu.launches_f64 if dtype == torch.float64 else
                   kimu.launches)
        assert launched[i] == {kimu.PROPAGATE: 2,
                               kimu.DESKEW: 2 if deskew else 0}
        assert tcounts.total(launched) == (4 if deskew else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", CUDA_DTYPES)
@pytest.mark.parametrize("deskew", [True, False])
def test_cuda_batched_lanes_match_one_lane_each(deskew, dt):
    _card()
    dtype, feed = DTYPES[dt]
    lanes = [_inputs(c, 64, 32768, dtype, feed, seed=s, device="cuda")[0]
             for s, c in enumerate(("padded", "stale_prefix", "no_valid",
                                    "padded"))]
    args = _stack(lanes)
    before = tcounts.snapshot()
    got = _vmapped(timu.propagate_and_deskew, args, deskew)
    launched = tcounts.since(before)
    want = _vmapped(timu.propagate_and_deskew_plain, args, deskew)
    torch.cuda.synchronize()
    i = _index(kimu.batched_launches)
    assert launched[i][64 if dtype == torch.float64 else 32] == (
        2 if deskew else 1)
    for b, lane in enumerate(lanes):
        one = _flat(timu.propagate_and_deskew(*lane, deskew=deskew))
        # a lane of the launch over lanes is the one-lane launch, bit for bit
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)
        _assert_close([g[b] for g in got], [w[b] for w in want], dtype)


@pytest.fixture
def fresh_tracer(monkeypatch):
    """The tracer's process-wide state, fresh for the test and off after
    it (``tests/test_torch_tracing.py``'s fixture)."""
    fresh = dict(ON=False, _device=None, _spans=[], _open=[], _ranges={},
                 _scan=0, _captured_off=False, _warned=False, _ring=None,
                 _count=None, _clock=None, _cpu_steps=0, _read=0,
                 _calib=None, counters=collections.Counter())
    for name, value in fresh.items():
        monkeypatch.setattr(tracing, name, value)
    yield
    tracing.disable()


@pytest.mark.cuda
@pytest.mark.parametrize("deskew", [True, False])
def test_cuda_captured_with_the_tracer_counts_its_launches(deskew,
                                                           fresh_tracer):
    _card()
    tracing.enable("cuda")
    args, _ = _inputs("padded", 64, 32768, torch.float32, torch.float32,
                      seed=9, device="cuda")
    static = [a.clone() if isinstance(a, torch.Tensor) else
              type(a)(*(v.clone() for v in a)) for a in args]

    def step():  # the stage between stamps 1 and 2; 7 closes the row
        tracing.stamp(1)
        out = timu.propagate_and_deskew(*static, deskew=deskew)
        tracing.stamp(2)
        tracing.stamp(tracing.STAMPS - 1)
        return out

    step()  # builds the libraries
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = tcounts.snapshot()
    with torch.cuda.graph(graph):
        out = step()
    recorded = tcounts.since(before)
    tcounts.restore(before)
    i = _index(kimu.launches)
    assert recorded[i] == {kimu.PROPAGATE: 1,
                           kimu.DESKEW: 1 if deskew else 0}
    want = _flat(step())
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(_flat(out), want):
        assert torch.equal(g, w)
    stamps = np.asarray(tracing.dump()["stamps"]["t"])
    assert len(stamps) >= 3 and (stamps[-3:, 2] > stamps[-3:, 1]).all()

"""The sorted segmented mean of the voxel downsample
(``kernels/segment_sum.py``, ``csrc/segment_sum.cu``).

On the CPU: the op's plain version against JAX's sorted
``jax.ops.segment_sum(..., indices_are_sorted=True)`` and the division of
``fast_lio_tpu/ops/voxel_grid.py``, bit for bit, in float32 and float64,
with 3 and 4 columns, dead points, empty segments and live points past the
last kept segment (the overflow segment n_out, dropped); the op under
``torch.func.vmap`` against a loop over the lanes, bit for bit; the op's
fake, the wrappers' checks and the bound (its chain term too);
``torch.segment_reduce`` on the same inputs against JAX, bit for bit.  The
adversarial cases of the kernel's ownership of points and ids
(``microbench_segment_sum.ADVERSARIAL_CASES``: one segment longer than a
staged tile, all dead, no point, every id kept with live points cut,
segments across every block boundary, 3 float32 columns at an odd N) run
in the JAX test and the card test.

On a card (marked ``cuda``; they skip without one): the kernel against
the plain version on a CPU copy of the same inputs, bit for bit, and two
launches bit-equal; the op inside a captured CUDA graph; the launch over a
stream axis lane by lane against single launches.  Run them on the card
host, which has no JAX (this file imports it lazily):
``python -m pytest -p no:cacheprovider --noconftest -m cuda
tests/test_torch_segment_sum.py``.
"""
import numpy as np
import pytest
import torch

from fast_lio_tpu_torch.batch import no_vmap_fallback
from fast_lio_tpu_torch.kernels import bounds
from fast_lio_tpu_torch.kernels import segment_sum as seg
from fast_lio_tpu_torch.ops.voxel_grid import voxel_segments
from fast_lio_tpu_torch.tools import microbench_segment_sum as mbs
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = [torch.float32, torch.float64]
N_OUT = 64


def _inputs(seed, dtype, C, N=700, n_live=600, n_out=N_OUT):
    """Sorted segment ids drawn from about 70% of 0..n_out (so some
    segments are empty, and some live points carry n_out, the overflow),
    then the dead points at n_out; columns from a normal draw, the dead
    points' too.  Numpy arrays (cols, live, seg_id)."""
    rng = np.random.default_rng(seed)
    pool = np.arange(n_out + 1)[rng.uniform(size=n_out + 1) < 0.7]
    pool = np.union1d(pool, [n_out])
    ids = np.sort(rng.choice(pool, n_live))
    seg_id = np.concatenate([ids, np.full(N - n_live, n_out)]).astype(np.int64)
    live = np.arange(N) < n_live
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    cols = rng.normal(0.0, 10.0, (N, C)).astype(np_dtype)
    assert (ids == n_out).any() and len(np.unique(ids)) < n_out
    return cols, live, seg_id


def _torch(cols, live, seg_id, device="cpu"):
    return (torch.tensor(cols, device=device),
            torch.tensor(live, device=device),
            torch.tensor(seg_id, device=device))


def _jax_segment_mean(cols, live, seg_id, n_out):
    """``fast_lio_tpu/ops/voxel_grid.py:108-117``'s sums, counts and
    division on the same inputs (imported here: the card host has no
    JAX)."""
    import jax
    import jax.numpy as jnp

    cols, seg_id = jnp.asarray(cols), jnp.asarray(seg_id)
    w = jnp.asarray(live).astype(cols.dtype)
    sums = jax.ops.segment_sum(cols * w[:, None], seg_id,
                               num_segments=n_out + 1,
                               indices_are_sorted=True)
    cnts = jax.ops.segment_sum(w, seg_id, num_segments=n_out + 1,
                               indices_are_sorted=True)
    sums, cnts = sums[:n_out], cnts[:n_out]
    return (np.asarray(sums / jnp.maximum(cnts, 1.0)[:, None]),
            np.asarray(cnts > 0))


def _launch_counts():
    return dict(seg.launches), dict(seg.batched_launches)


def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _adversarial(name, dtype, seed=mbs.ADVERSARIAL_SEED):
    """numpy (cols, live, seg_id, n_out) of the microbenchmark's
    adversarial generator ``name``."""
    return mbs.ADVERSARIAL_CASES[name](seed, _np_dtype(dtype))


# (dtype, C of the drawn gaps case, or an adversarial generator's name);
# the drawn cases keep their ids
JAX_CASES = [pytest.param(dtype, case, id=f"dtype{i}-{case}")
             for i, dtype in enumerate(DTYPES)
             for case in (3, 4, *mbs.ADVERSARIAL_CASES)]


@pytest.mark.parametrize("dtype,case", JAX_CASES)
def test_plain_version_matches_jax_sorted_segment_sum(dtype, case):
    """Bit for bit JAX's sums and division: on drawn ids with gaps (C = 3
    or 4), and on each adversarial case of the kernel's ownership
    (``microbench_segment_sum.ADVERSARIAL_CASES``)."""
    if case in (3, 4):
        cols, live, seg_id = _inputs(11 + case, dtype, case)
        n_out = N_OUT
    else:
        cols, live, seg_id, n_out = _adversarial(case, dtype)
    C = cols.shape[1]
    want_means, want_mask = _jax_segment_mean(cols, live, seg_id, n_out)
    before = _launch_counts()
    means, mask = seg.segment_mean(*_torch(cols, live, seg_id), n_out)
    assert _launch_counts() == before  # no kernel launch on CPU tensors
    assert means.dtype == dtype and tuple(means.shape) == (n_out, C)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(means.numpy(), want_means)
    # empty segments' means are +0.0, as the chain from +0.0 gives
    assert (means[~mask].view(torch.uint8) == 0).all()
    if case in (3, 4):
        # the inputs hold what the test is for: empty segments and the
        # overflow cut
        assert not want_mask.all() and want_mask.any()


@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_reduce_matches_jax_on_the_cpu(dtype, C):
    """The microbenchmark's ``torch.segment_reduce`` formulation of the same
    function (measured beside the kernel on the card, used nowhere in the
    port): on the CPU bit-equal to JAX's sorted sums and division."""
    from fast_lio_tpu_torch.tools.microbench_segment_sum import (
        segment_reduce_mean)

    cols, live, seg_id = _inputs(31 + C, dtype, C)
    want_means, want_mask = _jax_segment_mean(cols, live, seg_id, N_OUT)
    means, mask = segment_reduce_mean(*_torch(cols, live, seg_id), N_OUT)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(means.numpy(), want_means)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vmap_runs_the_plain_version_per_lane(dtype):
    """The op under ``torch.func.vmap`` (vmap's fallback off) on CPU
    tensors: each lane bit-equal to the op on that lane alone, and a
    shared (unbatched) input broadcast."""
    lanes = [_torch(*_inputs(20 + s, dtype, 4)) for s in range(3)]
    cols, live, seg_id = (torch.stack(t) for t in zip(*lanes))
    before = _launch_counts()

    def one(c, m, s):
        return seg.segment_mean(c, m, s, N_OUT)

    with no_vmap_fallback():
        got = torch.func.vmap(one)(cols, live, seg_id)
        shared = torch.func.vmap(one, in_dims=(0, None, None))(
            cols, live[0], seg_id[0])
    assert _launch_counts() == before
    for s, (c, m, i) in enumerate(lanes):
        want = seg.segment_mean_plain(c, m, i, N_OUT)
        assert all(torch.equal(g[s], w) for g, w in zip(got, want))
        want = seg.segment_mean_plain(c, live[0], seg_id[0], N_OUT)
        assert all(torch.equal(g[s], w) for g, w in zip(shared, want))


def test_op_fake_gives_the_kernel_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        cols = torch.empty((9, 4), dtype=torch.float64)
        means, mask = torch.ops.fast_lio_tpu_torch.segment_mean(
            cols, torch.empty(9, dtype=torch.bool),
            torch.empty(9, dtype=torch.int64), 5)
    assert tuple(means.shape) == (5, 4) and means.dtype == torch.float64
    assert tuple(mask.shape) == (5,) and mask.dtype == torch.bool


def test_cuda_wrappers_refuse_what_the_kernel_does_not_take():
    """The wrappers' checks, on the host: CUDA tensors only (nothing falls
    back to the plain version for a tensor that is not on the CPU), 3 or 4
    columns, bool and int64, one leading stream axis for the batched
    launch."""
    cols, live, seg_id = _torch(*_inputs(3, torch.float32, 3))
    with pytest.raises(ValueError, match="CUDA"):
        seg.segment_mean_cuda(cols, live, seg_id, N_OUT)
    with pytest.raises(ValueError, match="CUDA"):
        seg.segment_mean_cuda_batched(cols[None], live[None], seg_id[None],
                                      N_OUT)
    with pytest.raises(ValueError, match=r"\(S, N, C\)"):
        seg.segment_mean_cuda_batched(cols, live, seg_id, N_OUT)
    with pytest.raises(ValueError, match=r"\(N, C\)"):
        seg.segment_mean_cuda(cols[None], live[None], seg_id[None], N_OUT)


def test_bound_counts_each_byte_once():
    """N = 10 points into n_out = 3 segments, ids 0 0 1 1 1 then four at
    3 (overflow and dead): 5 points needed, 16 + 1 bytes each in float32
    with 4 columns, 8 bytes for each of 3 boundaries (segments 0 and 1 and
    the end), 16 + 1 out per segment; 9 operations a needed point and 4 a
    segment.  At this size the chain of 3 dependent adds outlasts the
    bytes, so it bounds it (``test_bound_chain_term``).  Twice the bytes
    over two lanes, float64 columns take twice the column bytes, and the
    dead points' bytes count for nothing."""
    ids = torch.tensor([0, 0, 1, 1, 1, 3, 3, 3, 3, 3])
    b = bounds.segment_mean_bound(ids, 4, 3, torch.float32)
    assert (b.nbytes, b.ops, b.by) == (5 * 17 + 3 * 8 + 3 * 17,
                                       5 * 9 + 3 * 4, "operations")
    assert b.ms == pytest.approx(max(
        b.nbytes / bounds.H100_HBM_BYTES_PER_S * 1e3, 1e-3 * b.chain_us))
    b2 = bounds.segment_mean_bound(torch.stack([ids, ids]), 4, 3,
                                   torch.float32)
    assert (b2.nbytes, b2.ops) == (2 * b.nbytes, 2 * b.ops)
    b64 = bounds.segment_mean_bound(ids, 3, 3, torch.float64)
    assert b64.nbytes == 5 * 25 + 3 * 8 + 3 * 25
    padded = torch.cat([ids, torch.full((90,), 3)])
    assert bounds.segment_mean_bound(padded, 4, 3, torch.float32) == b


def test_bound_chain_term():
    """The chain: the longest kept segment's points, one dependent add
    each, at ``ADD_CYCLES`` over ``H100_SM_CLOCK_HZ``.  Ids 0 0 1 1 1 then
    7 points at 3 (the overflow, not a chain): 3 adds; f64 adds take
    longer; over lanes the longest lane's; one segment of 20,000 points
    (40 us in float32 at 4 cycles an add) outlasts its 0.36 MB of bytes
    (0.1 us), so the chain bounds it, as "operations"; no kept point, no
    chain."""
    ids = torch.tensor([0, 0, 1, 1, 1, 3, 3, 3, 3, 3, 3, 3])
    clock = bounds.H100_SM_CLOCK_HZ
    for dtype in DTYPES:
        b = bounds.segment_mean_bound(ids, 4, 3, dtype)
        assert b.chain_us == pytest.approx(
            3 * bounds.ADD_CYCLES[dtype] / clock * 1e6)
    assert bounds.ADD_CYCLES[torch.float64] >= bounds.ADD_CYCLES[
        torch.float32]
    lanes = torch.stack([ids, torch.tensor([0] * 6 + [1] * 6)])
    assert bounds.segment_mean_bound(lanes, 4, 3, torch.float32).chain_us \
        == pytest.approx(6 * bounds.ADD_CYCLES[torch.float32] / clock * 1e6)
    one = torch.zeros(20000, dtype=torch.int64)
    b = bounds.segment_mean_bound(one, 4, 64, torch.float32)
    assert b.chain_us == pytest.approx(
        20000 * bounds.ADD_CYCLES[torch.float32] / clock * 1e6)
    assert b.by == "operations" and b.ms == pytest.approx(1e-3 * b.chain_us)
    assert b.nbytes / bounds.H100_HBM_BYTES_PER_S * 1e6 < 0.01 * b.chain_us
    dead = torch.full((10,), 3)
    assert bounds.segment_mean_bound(dead, 4, 3, torch.float32).chain_us == 0
    assert bounds.longest_segment(ids, 3) == 3


def test_ptxas_picks_the_launched_shape():
    """A build holds each (type, columns) twice, in the one-lane shape
    (``Narrow``) and the several-lane one (``Wide``); ``ptxas`` picks the
    case's, so the registers reported are those of the instance that
    ran."""
    def entry(t, c, shape):
        return (f"_ZN12_GLOBAL__N_119segment_mean_kernelI{t}Li{c}ENS_{shape}"
                "EEEvPKT_PKbPKxiiPS2_Pb")
    usage = {entry("f", 4, "6Narrow"): {"registers": 1},
             entry("f", 4, "4Wide"): {"registers": 2},
             entry("d", 4, "6Narrow"): {"registers": 3},
             entry("f", 3, "6Narrow"): {"registers": 4}}
    one = mbs.Case("t", torch.zeros(5, 4), torch.zeros(5, dtype=torch.bool),
                   torch.zeros(5, dtype=torch.int64), 3)
    lanes = mbs.Case("t", *(x[None] for x in one[1:4]), 3)
    assert mbs.ptxas(one, usage=usage) == {"registers": 1}
    assert mbs.ptxas(lanes, usage=usage) == {"registers": 2}
    assert mbs.ptxas(one._replace(cols=one.cols.double()),
                     usage=usage) == {"registers": 3}
    assert mbs.ptxas(one._replace(cols=one.cols[:, :3]),
                     usage=usage) == {"registers": 4}


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the segment_mean kernel has no "
                    "CPU mode")


def _voxel_inputs(seed, dtype, N=4096, n_out=1024):
    """A clustered cloud's points sorted by voxel key as the downsample
    sorts them (``voxel_segments``, the two-key path), more voxels than
    n_out, 10% of the points dead: numpy (cols (N, 4), live, seg_id)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-60.0, 60.0, size=(300, 3))
    pts = centers[rng.integers(0, 300, N)] + rng.normal(0, 0.4, (N, 3))
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    cols, live, seg_id = voxel_segments(
        torch.tensor(pts.astype(np_dtype)),
        torch.tensor(rng.uniform(size=N) < 0.9), 0.5, n_out,
        torch.tensor(rng.uniform(0, 255, N).astype(np_dtype)), 450 * 1.25 + 5)
    assert (seg_id[live] == n_out).any()  # the overflow cut is exercised
    return cols.numpy(), live.numpy(), seg_id.numpy(), n_out


CASES = {
    "gaps_c3": lambda dtype: (*_inputs(5, dtype, 3), N_OUT),
    "gaps_c4": lambda dtype: (*_inputs(6, dtype, 4), N_OUT),
    "voxels_c4": lambda dtype: _voxel_inputs(7, dtype),
    # the kernel's ownership of points and ids at its edges
    **{name: (lambda dtype, name=name: _adversarial(name, dtype))
       for name in mbs.ADVERSARIAL_CASES},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_matches_plain_version(dtype, case):
    _card()
    cols, live, seg_id, n_out = CASES[case](dtype)
    bits = 8 * torch.empty((), dtype=dtype).element_size()
    before = seg.launches[bits]
    got = seg.segment_mean(*_torch(cols, live, seg_id, "cuda"), n_out)
    again = seg.segment_mean(*_torch(cols, live, seg_id, "cuda"), n_out)
    torch.cuda.synchronize()
    assert seg.launches[bits] == before + 2
    want = seg.segment_mean_plain(*_torch(cols, live, seg_id), n_out)
    for g, a, w in zip(got, again, want):
        assert g.is_cuda and torch.equal(g.cpu(), w) and torch.equal(g, a)


@pytest.mark.cuda
def test_cuda_kernel_in_a_captured_graph():
    """The op recorded in a CUDA graph on static inputs, replayed on two
    other inputs copied in: each replay bit-equal to the plain version."""
    _card()
    cols, live, seg_id, n_out = _voxel_inputs(8, torch.float32)
    static = _torch(cols, live, seg_id, "cuda")
    seg.segment_mean(*static, n_out)  # built and loaded before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = seg.segment_mean(*static, n_out)
    for seed in (9, 10):
        inputs = _voxel_inputs(seed, torch.float32)[:3]
        for s, x in zip(static, _torch(*inputs, "cuda")):
            s.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        want = seg.segment_mean_plain(*_torch(*inputs), n_out)
        assert all(torch.equal(o.cpu(), w) for o, w in zip(out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_batched_launch_matches_single_launches(dtype):
    """vmap of the op on CUDA tensors: one launch over the stream axis
    (counted in ``batched_launches``, no single launch), each lane bit-equal
    to the single launch on it and to the plain version."""
    _card()
    lanes = [_torch(*_voxel_inputs(30 + s, dtype)[:3], "cuda")
             for s in range(4)]
    cols, live, seg_id = (torch.stack(t) for t in zip(*lanes))
    bits = 8 * torch.empty((), dtype=dtype).element_size()
    before = _launch_counts()
    with no_vmap_fallback():
        got = torch.func.vmap(
            lambda c, m, s: seg.segment_mean(c, m, s, 1024))(cols, live,
                                                             seg_id)
    torch.cuda.synchronize()
    single, batched = _launch_counts()
    assert single == before[0] and batched[bits] == before[1][bits] + 1
    for s, lane in enumerate(lanes):
        one = seg.segment_mean_cuda(*lane, 1024)
        want = seg.segment_mean_plain(*(t.cpu() for t in lane), 1024)
        for g, o, w in zip(got, one, want):
            assert torch.equal(g[s], o) and torch.equal(g[s].cpu(), w)

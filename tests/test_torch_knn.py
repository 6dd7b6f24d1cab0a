"""The kNN search of the port: its plain version against the JAX package's
XLA search and its Pallas kernel (interpret mode, loaded as
tests/test_knn_pallas.py loads it), the kernel wrapper's routing and host
logic on CPU (ring sizes, tile unions), and on a GPU the CUDA kernel against
the plain version on coherent, shuffled, clamped and union-overflow scenes.

The rule of tests/test_knn_pallas.py: found masks equal; squared distances
within rtol 1e-5 (atol 1e-6); neighbours equal (1e-6) wherever the
distances are distinct, since tie order may differ.  Against the XLA search,
which does the same arithmetic in the same order, found and sq must also be
bit-equal.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from fast_lio_tpu_torch.kernels import knn as tknn
from fast_lio_tpu_torch.map import hash_map as thm
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@functools.cache
def _jax_side():
    """(jnp, the JAX hash_map, knn_pallas, a jitted JAX insert), imported
    on first use: the CUDA case runs on a GPU host that has no JAX
    (``pytest --noconftest -m cuda tests/test_torch_knn.py``)."""
    import jax
    import jax.numpy as jnp

    from fast_lio_tpu.map import hash_map as jhm

    p = Path(__file__).resolve().parent.parent / "tools" / "knn_pallas.py"
    spec = importlib.util.spec_from_file_location("knn_pallas", p)
    kp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kp)
    return jnp, jhm, kp, jax.jit(jhm.insert, static_argnums=1)


def _cfg(B):
    return thm.MapConfig(h_log2=10, bucket_slots=B, cell_size=1.0, voxel_size=0.5)


def _port_map(points, B, device="cpu"):
    """A map holding ``points`` (inserted without downsample)."""
    cfg = _cfg(B)
    on = torch.ones(len(points), dtype=torch.bool, device=device)
    return cfg, thm.insert(thm.make_map(cfg, torch.float32, device), cfg,
                           torch.tensor(points, device=device), on, ~on)


def _maps(points, B):
    """The same map in both packages, checked bit-identical."""
    jnp, jhm, _kp, j_insert = _jax_side()
    cfg, tm = _port_map(points, B)
    jcfg = jhm.MapConfig(*cfg)
    on = jnp.ones(len(points), bool)
    jm = j_insert(jhm.make_map(jcfg, jnp.float32), jcfg, jnp.asarray(points),
                  on, ~on)
    np.testing.assert_array_equal(tm.packed.numpy(), np.asarray(jm.packed))
    return cfg, jm, tm


def _rule(got, ref):
    nb_g, sq_g, f_g = (np.asarray(a) for a in got)
    nb_r, sq_r, f_r = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(f_g, f_r)
    np.testing.assert_allclose(np.where(f_r, sq_g, 0.0), np.where(f_r, sq_r, 0.0),
                               rtol=1e-5, atol=1e-6)
    sq_f = np.where(f_r, sq_r, -1.0)  # missing entries tie with nothing
    tied = (np.abs(sq_f[:, :, None] - sq_f[:, None, :]) < 1e-9).sum(-1) > 1
    strict = f_r & ~tied
    np.testing.assert_allclose(nb_g[strict], nb_r[strict], rtol=1e-6, atol=1e-6)


def _np(res):
    return tuple(t.cpu().numpy() for t in res)


def _scene(case, rng):
    if case == "dense":
        pts = rng.uniform(-6, 6, size=(3000, 3))
        q = rng.uniform(-5, 5, size=(64, 3))
    elif case == "sparse_and_empty":
        pts = np.concatenate([
            rng.uniform(-2, 2, size=(500, 3)),
            [[8.0, 8.0, 8.0], [8.3, 8.0, 8.0], [-7.0, 5.0, 0.0]]])
        q = np.concatenate([
            rng.uniform(-2, 2, size=(16, 3)),
            [[8.1, 8.0, 8.0], [20.0, 20.0, 20.0], [-7.2, 5.1, 0.0]],
            np.zeros((13, 3))])
    else:  # wide
        pts = rng.uniform(-4, 4, size=(800, 3))
        q = rng.uniform(-4, 4, size=(32, 3))
    return pts.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("B", [16, 128])
@pytest.mark.parametrize("case", ["dense", "sparse_and_empty", "wide"])
def test_plain_knn_matches_jax_and_pallas(case, B):
    rng = np.random.default_rng(61)
    pts, q = _scene(case, rng)
    cfg, jm, tm = _maps(pts, B)
    jnp, jhm, kp, _ = _jax_side()
    wide = case == "wide"
    got = _np(thm.knn_search(tm, cfg, torch.tensor(q), wide=wide))
    xla = jhm.knn_search(jm, jhm.MapConfig(*cfg), jnp.asarray(q), wide=wide)
    pallas = kp.knn_search_pallas(jm, jhm.MapConfig(*cfg), jnp.asarray(q),
                                  wide=wide, interpret=True)
    _rule(got, xla)
    _rule(got, pallas)
    np.testing.assert_array_equal(got[1], np.asarray(xla[1]))
    np.testing.assert_array_equal(got[2], np.asarray(xla[2]))
    assert got[2].any()
    assert got[2].all() != (case == "sparse_and_empty")


def test_found_counts_match_region_brute_force():
    rng = np.random.default_rng(62)
    pts = rng.uniform(-3, 3, size=(200, 3)).astype(np.float32)
    cfg, tm = _port_map(pts, 16)
    q = rng.uniform(-3, 3, size=(24, 3)).astype(np.float32)
    found = thm.knn_search(tm, cfg, torch.tensor(q))[2].numpy()
    for i, qi in enumerate(q):
        base = np.floor(qi / cfg.cell_size - 0.5)
        lo, hi = base * cfg.cell_size, (base + 2) * cfg.cell_size
        in_region = ((pts >= lo) & (pts < hi)).all(-1)
        assert found[i].sum() == min(5, int(in_region.sum()))


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    rng = np.random.default_rng(63)
    pts, q = _scene("dense", rng)
    cfg, tm = _port_map(pts, 16)
    before = dict(tknn.launches)
    for wide in (False, True):
        got = tknn.knn_search(tm, cfg, torch.tensor(q), wide=wide)
        want = thm.knn_search(tm, cfg, torch.tensor(q), wide=wide)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert tknn.launches == before  # no kernel launch on CPU tensors
    with pytest.raises(ValueError, match="CUDA"):
        tknn.knn_search_cuda(tm.packed, cfg, torch.tensor(q))
    with pytest.raises(ValueError, match="k=5"):
        tknn.knn_search_cuda(tm.packed, cfg, torch.tensor(q), k=4)


def _stream_scenes(S, dtype=torch.float32, device="cpu"):
    """S different maps (B = 16) and S query sets of one size, stacked:
    (cfg, rows (S, H + 1, 4B) with each map's dump row, queries (S, N, 3))."""
    maps, qs = [], []
    for s in range(S):
        pts, q = _scene("dense", np.random.default_rng(70 + s))
        cfg, tm = _port_map(pts, 16, device=device)
        maps.append(tm.rows)
        qs.append(torch.tensor(q, device=device))
    return (cfg, torch.stack(maps).to(dtype), torch.stack(qs).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wide", [False, True])
def test_knn_op_vmap_rule_runs_the_plain_search_per_stream(wide, dtype):
    """(a) The custom op under ``torch.func.vmap`` (vmap's fallback off) on
    CPU tensors: each stream's rows are its plain search's, bit for bit, and
    no kernel launch is counted.  A map shared by the streams is
    broadcast."""
    from fast_lio_tpu_torch.batch import no_vmap_fallback

    cfg, rows, q = _stream_scenes(3, dtype)
    H = cfg.num_buckets
    counters = (tknn.launches, tknn.launches_f64, tknn.batched_launches,
                tknn.batched_launches_f64)
    before = [dict(c) for c in counters]

    def one(packed, queries):
        return tknn.knn_search(thm.Map(packed, None), cfg, queries, wide=wide)

    with no_vmap_fallback():
        got = torch.func.vmap(one)(rows[:, :H], q)
        shared = torch.func.vmap(one, in_dims=(None, 0))(rows[0, :H], q)
    for s in range(3):
        want = thm.knn_search(thm.Map(rows[s, :H], None), cfg, q[s],
                              wide=wide)
        _bit_equal(_np(tuple(g[s] for g in got)), _np(want))
        want = thm.knn_search(thm.Map(rows[0, :H], None), cfg, q[s],
                              wide=wide)
        _bit_equal(_np(tuple(g[s] for g in shared)), _np(want))
    assert got[0].dtype == dtype and got[2].any()
    assert [dict(c) for c in counters] == before


def test_knn_op_fake_gives_the_kernel_shapes():
    """The op's fake (``register_fake``): outputs of the kernel's shapes and
    dtypes, with no data."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = _cfg(16)
    with FakeTensorMode():
        packed = torch.empty((cfg.num_buckets, 64))
        q = torch.empty((7, 3), dtype=torch.float32)
        nbrs, sq, found = torch.ops.fast_lio_tpu_torch.knn_search(
            packed, q, cfg.h_log2, cfg.bucket_slots, cfg.cell_size,
            cfg.voxel_size, 5, False)
    assert tuple(nbrs.shape) == (7, 5, 3) and tuple(sq.shape) == (7, 5)
    assert tuple(found.shape) == (7, 5) and found.dtype == torch.bool
    assert sq.dtype == torch.float32


def test_batched_launch_refuses_what_the_kernel_does_not_take():
    """The batched wrapper's checks, on the host: one leading stream axis
    of a size, maps 16-byte aligned apart, CUDA tensors."""
    cfg, rows, q = _stream_scenes(2)
    H = cfg.num_buckets
    with pytest.raises(ValueError, match="stream axis"):
        tknn.knn_search_cuda_batched(rows[:, :H], cfg, q[:1])
    with pytest.raises(ValueError, match="aligned"):
        tknn.knn_search_cuda_batched(
            rows.reshape(-1)[2:2 + 2 * H * 64].reshape(2, H, 64)
            .as_strided((2, H, 64), (H * 64 + 2, 64, 1)), cfg, q)
    with pytest.raises(ValueError, match="CUDA"):
        tknn.knn_search_cuda_batched(rows[:, :H], cfg, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("S", [1, 4])
def test_cuda_batched_kernel_matches_plain_search_per_stream(S, wide, dtype):
    """One launch over S stacked maps (each with its dump row, so the maps
    are (H + 1) * 4B apart) and S query sets: each stream's rows bit-equal
    to its plain search and to the single launch on that map (at S = 1,
    today's launch); one launch counted.  Float64 off the float32 grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kNN kernel has no CPU mode")
    maps, qs = [], []
    for s in range(S):
        cfg, tm, q = cuda_scene(["coherent", "shuffled", "union_overflow",
                                 "clamped"][s], 16, n=8192, seed=80 + s)
        if dtype == torch.float64:
            tm, q = _f64(tm, q, seed=90 + s)
            tm = thm.from_packed(tm.packed, tm.dropped)
        maps.append(tm.rows)
        qs.append(q)
    rows, q = torch.stack(maps), torch.stack(qs)
    H = cfg.num_buckets
    r = 27 if wide else 8
    counter = (tknn.batched_launches_f64 if dtype == torch.float64
               else tknn.batched_launches)
    before = counter[r]
    got = tknn.knn_search_cuda_batched(rows[:, :H], cfg, q, wide=wide)
    torch.cuda.synchronize()
    assert counter[r] == before + 1
    assert rows[:, :H].stride(0) == (H + 1) * 4 * 16
    for s in range(S):
        mine = tuple(g[s] for g in got)
        single = tknn.knn_search_cuda(rows[s, :H].contiguous(), cfg, q[s],
                                      wide=wide)
        for a, b in zip(mine, single):
            assert torch.equal(a, b)
        m = thm.Map(rows[s, :H].contiguous(), None)
        _bit_equal(_np(mine), _np(thm.knn_search(m, cfg, q[s], wide=wide)))
        assert mine[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 128])
@pytest.mark.parametrize("case", ["dense", "sparse_and_empty", "wide"])
def test_cuda_kernel_matches_plain_version(case, B):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kNN kernel has no CPU mode")
    rng = np.random.default_rng(64)
    pts, q = _scene(case, rng)
    cfg, tm = _port_map(pts, B, device="cuda")
    wide = case == "wide"
    qc = torch.tensor(q, device="cuda")
    r = 27 if wide else 8
    before = tknn.launches[r]
    got = tknn.knn_search(tm, cfg, qc, wide=wide)
    torch.cuda.synchronize()
    assert tknn.launches[r] == before + 1
    ref = thm.knn_search(tm, cfg, qc, wide=wide)
    _rule(_np(got), _np(ref))


@pytest.mark.parametrize("B, rows", [(16, 16), (64, 16), (128, 16),
                                     (256, 16), (512, 8), (4096, 1)])
def test_ring_rows_per_bucket_width(B, rows):
    """Two stages of 16 rows (32 KB at B = 64, 64 KB at B = 128), fewer
    where they would pass the ring's 128 KB."""
    assert tknn.ring_rows(B) == rows
    assert 2 * rows * 16 * B <= tknn.RING_BYTES


def test_ring_refuses_a_row_wider_than_its_stage():
    with pytest.raises(ValueError, match="does not fit"):
        tknn.ring_rows(8192)
    with pytest.raises(ValueError, match="does not fit"):
        tknn.ring_rows(4096, 8)


@pytest.mark.parametrize("B, rows", [(16, 16), (64, 16), (128, 16),
                                     (256, 8), (512, 4), (2048, 1)])
def test_ring_rows_in_float64(B, rows):
    """A float64 row takes twice the bytes: two stages of 16 rows fill the
    ring's 128 KB at B = 128, and wider rows halve the rows a stage."""
    assert tknn.ring_rows(B, 8) == rows
    assert 2 * rows * 32 * B <= tknn.RING_BYTES


def test_knn_bound_in_float64_counts_twice_the_bytes():
    """The same map and queries in float64: the same rows and operations;
    rows, queries, neighbours and distances at 8 bytes (found flags stay 1
    byte), and the operations at the FP64 rate."""
    from fast_lio_tpu_torch.kernels import bounds

    rng = np.random.default_rng(67)
    pts, q = _scene("dense", rng)
    cfg, tm = _port_map(pts, 64)
    qt = torch.tensor(q)
    b32 = bounds.knn_bound(tm, cfg, qt)
    b64 = bounds.knn_bound(thm.Map(tm.packed.double(), tm.dropped), cfg,
                           qt.double())
    n, k = len(q), thm.NUM_MATCH_POINTS
    assert b64.distinct_rows == b32.distinct_rows and b64.ops == b32.ops
    rows32 = b32.distinct_rows * 4 * 64 * 4
    assert b32.nbytes == rows32 + n * (12 + 17 * k)
    assert b64.nbytes == 2 * rows32 + n * (24 + 33 * k)
    assert b64.ms == max(b64.nbytes / bounds.H100_HBM_BYTES_PER_S,
                         b64.ops / bounds.H100_F64_FLOPS) * 1e3
    assert bounds.H100_F64_FLOPS == 34e12


def test_wrapper_routes_float64_cpu_tensors_to_the_plain_version():
    rng = np.random.default_rng(68)
    pts, q = _scene("wide", rng)
    cfg, tm = _port_map(pts, 16)
    m64 = thm.Map(tm.packed.double(), tm.dropped)
    q64 = torch.tensor(q, dtype=torch.float64)
    before = (dict(tknn.launches), dict(tknn.launches_f64))
    for wide in (False, True):
        got = tknn.knn_search(m64, cfg, q64, wide=wide)
        want = thm.knn_search(m64, cfg, q64, wide=wide)
        assert got[0].dtype == got[1].dtype == torch.float64
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (tknn.launches, tknn.launches_f64) == before


def test_pipeline_refuses_the_grouped_backend_in_float64():
    """At construction, naming the dtype (the grouped kernels are float32
    only); the default backend takes float64."""
    from fast_lio_tpu_torch import config as tcfg
    from fast_lio_tpu_torch import pipeline as tpipe

    cfg = tcfg.Config(n_points_max=1024, n_ds_max=512, map_h_log2=10,
                      compute_dtype="float64")
    with pytest.raises(ValueError, match="float64"):
        tpipe.Pipeline(dataclasses.replace(cfg, knn_backend="grouped"),
                       device="cpu")
    assert tpipe.Pipeline(cfg, device="cpu").map.packed.dtype == torch.float64


def test_tile_union_stats_on_a_scene():
    """Tiles of queries in one storage cell stage that region's rows once;
    tiles of queries in distinct far-apart cells stage R rows per query
    (less the hash collisions), and take several chunks of the ring.
    Tiles hold 16 queries at R = 8 and 8 at R = 27."""
    cfg = thm.MapConfig(h_log2=15, bucket_slots=64, cell_size=1.0,
                        voxel_size=0.5)
    rng = np.random.default_rng(66)
    one_cell = torch.tensor(rng.uniform(1.1, 1.4, (64, 3)), dtype=torch.float32)
    for wide, tiles in ((False, 4), (True, 8)):
        st = tknn.tile_union_stats(one_cell, cfg, wide)
        _b, cells, _R = thm.region_cells(one_cell[:1], cfg, wide)
        rows = len(set(thm._bucket_of(cells, cfg.h_log2)[0].tolist()))
        assert st["tiles"] == tiles
        assert st["mean_rows"] == st["max_rows"] == rows
        assert st["mean_chunks"] == -(-rows // tknn.ring_rows(64))
    apart = torch.tensor(np.arange(20)[:, None] * np.array([[10.0, 7.0, 3.0]])
                         + 0.2, dtype=torch.float32)  # 20 distinct regions
    st = tknn.tile_union_stats(apart, cfg)
    buckets = thm._bucket_of(thm.region_cells(apart, cfg)[1], cfg.h_log2)
    want = [len(set(buckets[:16].reshape(-1).tolist())),
            len(set(buckets[16:].reshape(-1).tolist()))]
    assert st["tiles"] == 2 and st["max_rows"] == max(want)
    assert st["mean_rows"] == sum(want) / 2
    assert want[0] > 120  # 16 queries x 8 cells, few collisions in 2^15
    ring = tknn.ring_rows(64)
    assert st["mean_chunks"] == sum(-(-w // ring) for w in want) / 2
    assert st["mean_chunks"] > 2
    assert tknn.tile_union_stats(apart[:0], cfg)["tiles"] == 0


CUDA_N = (1, 7, 8, 9, 33, 8192, 8193)
CUDA_SCENES = ["coherent", "shuffled", "clamped", "union_overflow"]


def cuda_scene(scene, B, n=max(CUDA_N), device="cuda", seed=65):
    """(cfg, map, queries (n, 3)) of one scene at bucket width B.

    coherent: queries in voxel order (as the voxel downsample emits them,
    about 8 per storage cell); shuffled: the same queries permuted;
    clamped: queries beyond 512 storage cells (x near 600 and 700, where the
    grouped search's 10-bit key saturates); union_overflow: queries spread
    over 24^3 cells, so a tile's distinct rows overflow the kernel's ring."""
    rng = np.random.default_rng(seed)
    cfg = _cfg(B)
    if scene == "clamped":
        pts = np.concatenate([
            rng.uniform([598, -2, -2], [602, 2, 2], size=(3000, 3)),
            rng.uniform([698, -2, -2], [702, 2, 2], size=(3000, 3))])
        x = np.where(np.arange(n) % 2 == 0, 600.0, 700.0)
        q = np.stack([x, np.zeros(n), np.zeros(n)], -1) + rng.uniform(
            -0.4, 0.4, size=(n, 3))
    elif scene == "union_overflow":
        pts = rng.uniform(-12, 12, size=(20000, 3))
        q = rng.uniform(-12, 12, size=(n, 3))
    else:
        pts = rng.uniform(-6, 6, size=(6000, 3))
        q = rng.uniform(-5, 5, size=(n, 3))
        v = np.floor(q / 0.5).astype(np.int64)
        q = q[np.lexsort((v[:, 2], v[:, 1], v[:, 0]))]
        if scene == "shuffled":
            q = q[rng.permutation(n)]
    cfg, tm = _port_map(pts.astype(np.float32), B, device=device)
    return cfg, tm, torch.tensor(q.astype(np.float32), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("B", [16, 64, 128])
@pytest.mark.parametrize("scene", CUDA_SCENES)
def test_cuda_tile_kernel_matches_plain_version_on_scenes(scene, B, wide):
    """At N = 1, 7, 8, 9, 33, 8192 and 8193 (partial tiles, one tile, many
    tiles), under the rule of tests/test_knn_pallas.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kNN kernel has no CPU mode")
    cfg, tm, q = cuda_scene(scene, B)
    r = 27 if wide else 8
    for n in CUDA_N:
        qn = q[:n].contiguous()
        before = tknn.launches[r]
        got = tknn.knn_search(tm, cfg, qn, wide=wide)
        torch.cuda.synchronize()
        assert tknn.launches[r] == before + 1
        _rule(_np(got), _np(thm.knn_search(tm, cfg, qn, wide=wide)))
        if n >= 33:
            assert got[2].any()


def _f64(tm, q, seed=69):
    """The map and queries in float64, off the float32 grid."""
    from fast_lio_tpu_torch.tools.microbench_knn import off_float32

    return off_float32(tm, q, seed)


def _bit_equal(got, ref):
    """Found and sq bit-equal, and neighbours bit-equal where found."""
    nb_g, sq_g, f_g = (np.asarray(a) for a in got)
    nb_r, sq_r, f_r = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(f_g, f_r)
    np.testing.assert_array_equal(sq_g, sq_r)
    np.testing.assert_array_equal(nb_g[f_r], nb_r[f_r])


def test_float64_scenes_hold_values_float32_cannot():
    """``_f64`` moves every nonzero coordinate of the map and the queries
    off the float32 grid, by less than half a float32 ulp (they round back
    to the float32 values), and keeps the w channel."""
    cfg, tm, q = cuda_scene("coherent", 16, n=256, device="cpu")
    m64, q64 = _f64(tm, q)
    B = cfg.bucket_slots
    xyz32, xyz64 = tm.packed[:, :3 * B], m64.packed[:, :3 * B]
    assert torch.equal(m64.packed[:, 3 * B:], tm.packed[:, 3 * B:].double())
    for v32, v64 in ((xyz32, xyz64), (q, q64)):
        assert v64.dtype == torch.float64
        assert torch.equal(v64.float(), v32)
        nz = v32 != 0
        assert nz.sum() > 100
        assert bool((v64.float().double() != v64)[nz].all())


@pytest.mark.parametrize("wide", [False, True])
def test_bit_equality_fails_a_float64_search_done_in_float32(wide):
    """The float64 kernel's check catches the fault it is there for: the
    plain search run in float32 on the same off-grid inputs and returned in
    float64 (what a kernel that casts, or computes in float32, gives) is
    not bit-equal to the float64 search."""
    cfg, tm, q = cuda_scene("coherent", 16, n=256, device="cpu")
    m64, q64 = _f64(tm, q)
    want = thm.knn_search(m64, cfg, q64, wide=wide)
    _bit_equal(want, want)
    in_f32 = thm.knn_search(thm.Map(m64.packed.float(), m64.dropped), cfg,
                            q64.float(), wide=wide)
    assert torch.equal(in_f32[2], want[2]) and bool(want[2].any())
    with pytest.raises(AssertionError):
        _bit_equal(tuple(t.double() if t.is_floating_point() else t
                         for t in in_f32), want)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("B", [16, 64, 128])
@pytest.mark.parametrize("scene", CUDA_SCENES)
def test_cuda_float64_kernel_matches_plain_version_on_scenes(scene, B, wide):
    """The float64 instantiation on the scenes moved off the float32 grid
    (``_f64``), at N = 1 .. 8193, bit-equal to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kNN kernel has no CPU mode")
    cfg, tm, q = cuda_scene(scene, B)
    m64, q64 = _f64(tm, q)
    r = 27 if wide else 8
    for n in CUDA_N:
        qn = q64[:n].contiguous()
        before = (tknn.launches_f64[r], tknn.launches[r])
        got = tknn.knn_search(m64, cfg, qn, wide=wide)
        torch.cuda.synchronize()
        assert (tknn.launches_f64[r], tknn.launches[r]) == (before[0] + 1,
                                                            before[1])
        assert got[0].dtype == got[1].dtype == torch.float64
        _bit_equal(_np(got), _np(thm.knn_search(m64, cfg, qn, wide=wide)))
        if n >= 33:
            assert got[2].any()


@pytest.mark.cuda
def test_cuda_kernel_refuses_other_dtypes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kNN kernel has no CPU mode")
    cfg, tm, q = cuda_scene("coherent", 16, n=64)
    with pytest.raises(ValueError, match="float32 or float64"):
        tknn.knn_search(tm, cfg, q.half())
    with pytest.raises(ValueError, match="queries are torch.float64"):
        tknn.knn_search(tm, cfg, q.double())


@pytest.mark.cuda
def test_cuda_float64_pipeline_runs_on_the_float64_kernel():
    """A few scans of Pipeline(compute_dtype="float64") on the card: the
    float64 kernel ran and the float32 one did not; positions within 5 mm
    of the CPU run (the card's run is not held bit for bit to the CPU's:
    where the two would part is not measured)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kNN kernel has no CPU mode")
    from fast_lio_tpu_torch import config as tcfg
    from fast_lio_tpu_torch import pipeline as tpipe
    from fast_lio_tpu_torch import sim as tsim

    cfg = tcfg.Config(lidar_type=tcfg.LidarType.AVIA, filter_size_surf=0.3,
                      filter_size_map=0.3, n_points_max=2048, n_ds_max=1024,
                      n_imu_max=32, map_h_log2=12, det_range=40.0,
                      compute_dtype="float64")
    data = tsim.generate(tsim.SimConfig(duration=0.8, n_rings=8,
                                        n_azimuth=200, range_noise=0.01))
    with pytest.raises(ValueError, match="float64"):
        tpipe.Pipeline(dataclasses.replace(cfg, knn_backend="grouped"))
    pos = {}
    before = (dict(tknn.launches), dict(tknn.launches_f64))
    for dev in ("cuda", "cpu"):
        pipe = tpipe.Pipeline(cfg, device=dev)
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
        pos[dev] = np.stack([p for _, p, _ in pipe.get_trajectory()])
    assert tknn.launches == before[0]
    assert tknn.launches_f64[8] > before[1][8]
    assert pos["cuda"].shape == pos["cpu"].shape and len(pos["cpu"]) >= 5
    np.testing.assert_allclose(pos["cuda"], pos["cpu"], rtol=0, atol=5e-3)

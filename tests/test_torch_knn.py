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
